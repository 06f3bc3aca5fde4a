"""Exported serving programs (engine/aot.py) of the EVAL switches on the CPU:
the weight maps (x8 'lr-lrblur' with a1..a3, x16 with a1..a4) and the
stage-1 generator. The blur and the maps live inside the exported forward,
so the loaded program, with no model module, gives the live pipeline's
uint8 SR bit for bit (the same ATen ops and plain kernel versions), and its
graph holds the kernel ops the path launches on the card: stage 1 one
attention and one up-head site.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
from tgsr_tpu_torch.config import Config, EvalConfig, GanConfig, TextConfig, TreeConfig
from tgsr_tpu_torch.engine import aot
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests.torch_parity import VOCAB, inputs

torch.set_num_threads(1)
T = 6
VARIANTS = {  # name: (branch_num, base_size, INPUT_NETGH, WEIGHTMAP, STAGE1, path)
    "x8 map float32": (4, 32, "lr-lrblur", True, False, "float32"),
    "x8 map bfloat16": (4, 32, "lr-lrblur", True, False, "bfloat16"),
    "x8 stage1 float32": (4, 8, "lr", False, True, "float32"),
    "x8 stage1 int8": (4, 8, "lrblur", False, True, "int8"),
    "x16 map bfloat16": (5, 8, "lr-lrblur", True, False, "bfloat16"),
}
# the tgsr:: op nodes of each program: the kernels of its path
OPS = {
    "x8 map float32": {"word_pixel_attention": 3, "up_head": 2},
    "x8 map bfloat16": {"word_pixel_attention": 3, "up_head_packed": 2},
    "x8 stage1 float32": {"word_pixel_attention": 1, "up_head": 1},
    "x16 map bfloat16": {"word_pixel_attention": 4, "up_head_packed": 2},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_exported_variant_equals_live(name, tmp_path):
    branch, size, low, wm, st1, path = VARIANTS[name]
    cfg = Config(TREE=TreeConfig(BRANCH_NUM=branch, BASE_SIZE=size),
                 GAN=GanConfig(GF_DIM=8, CONDITION_DIM=10, R_NUM=2),
                 TEXT=TextConfig(EMBEDDING_DIM=32, WORDS_NUM=T),
                 EVAL=EvalConfig(INPUT_NETGH=low, WEIGHTMAP=wm, STAGE1=st1))
    sds = init_seeded(cfg, VOCAB, torch.Generator().manual_seed(1))
    lr, cap, lens = inputs(3, size, T, [T, 0, 3], seed=2)
    dtype = torch.float32 if path == "float32" else torch.bfloat16
    kw = {}
    if path == "int8":
        kw["quant_scales"] = SRPipeline(cfg, VOCAB, *sds, device="cpu",
                                        compute_dtype=dtype).calibrate_quant(lr, cap, lens)
    live = SRPipeline(cfg, VOCAB, *sds, device="cpu", compute_dtype=dtype, **kw)
    pipe = aot.AOTPipeline(aot.export_serving(live, str(tmp_path)), device="cpu")
    np.testing.assert_array_equal(pipe.sr_uint8(lr, cap, lens), live.sr_uint8(lr, cap, lens))
    if name in OPS:
        found = Counter(str(n.target).split(".")[1] for n in pipe.module.graph.nodes
                        if n.op == "call_function" and str(n.target).startswith("tgsr."))
        assert dict(found) == OPS[name]
