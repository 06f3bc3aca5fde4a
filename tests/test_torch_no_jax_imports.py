"""Hygiene of the PyTorch port: tgsr_tpu_torch (every file under it, cli/
included) and chip_smoke.py import nothing of JAX, flax, msgpack, PIL,
OpenCV, skimage, PyYAML, nltk or tgsr_tpu, the port's weights carry
exactly the reference state-dict keys and shapes that tgsr_tpu's exporter
emits (x8 and x16), and the ctypes signatures agree with the kernels' C interfaces."""

import ast
import os
import re

import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints import export_torch
from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, state_dicts_from_jax
from tgsr_tpu_torch.ops import _build
from tgsr_tpu_torch.models.generator import GSRNetLow
from tgsr_tpu_torch.models.generator_hf import NetGHighWeight
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tgsr_tpu_torch.models.models16 import make_generators, unused_blocks
from tests.torch_parity import VOCAB, configs, jax_trees, jax_trees16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the card machine has none of these: msgpack files are read by the port's
# own checkpoints/msgpack_io.py, PNGs and JPEGs by data/codec.py (zlib and the
# port's C decoder, csrc/jpeg_decode.c), YAML configs
# by config.py's own reader, the stopwords are a built-in list, and the
# attention grids resize, blend and draw text in numpy and scipy
# (utils/visualize.py, utils/skimage_compat.py)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tgsr_tpu", "msgpack", "PIL", "yaml",
             "nltk", "cv2", "skimage")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tgsr_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_walk_covers_every_port_package():
    """The walk reaches each subpackage of the port, the CLIs included."""
    dirs = {os.path.relpath(os.path.dirname(p), ROOT) for p in _port_files()}
    for sub in ("cli", "data", "engine", "ops", "checkpoints", "models", "utils", "probes",
                "losses", "parallel", "native"):
        assert os.path.join("tgsr_tpu_torch", sub) in dirs
    files = _port_files()
    for rel in ("cli/serve.py", "cli/test.py", "cli/calibrate.py", "data/datasets.py",
                "data/pipeline.py", "utils/visualize.py", "utils/skimage_compat.py",
                "cli/pretrain_damsm.py", "cli/eval_rank.py", "engine/damsm_trainer.py",
                "losses/damsm.py", "models/image_encoder.py", "engine/aot.py",
                "cli/export_aot.py", "cli/export_torch.py", "checkpoints/export_torch.py",
                "ops/library.py", "ops/quantize.py", "models/variants.py", "models/vgg.py",
                "losses/mani.py", "utils/init.py", "parallel/mesh.py", "parallel/multihost.py",
                "parallel/data_parallel.py", "checkpoints/dcp_io.py", "utils/preemption.py",
                "native/__init__.py", "utils/observability.py", "data/codec.py",
                "ops/int8_upconv.py", "utils/deconv_viz.py", "parallel/spatial.py",
                "parallel/pipeline.py"):
        assert os.path.join(ROOT, "tgsr_tpu_torch", *rel.split("/")) in files, rel


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture(scope="module")
def trees():
    jcfg, tcfg = configs()
    return jcfg, tcfg, jax_trees(jcfg)


def _shapes(sd):
    return {k: tuple(np.shape(v)) for k, v in sd.items()}


def _modules(tcfg):
    E = tcfg.TEXT.EMBEDDING_DIM
    return (TextEncoder(VOCAB, 300, E),
            GSRNetLow(tcfg.GAN.GF_DIM, E, tcfg.GAN.CONDITION_DIM, tcfg.n_stages,
                      tcfg.GAN.R_NUM),
            NetGHighWeight(tcfg.GAN.GF_DIM))


@pytest.mark.parametrize("which", ["text", "netg", "netgh"])
def test_state_dict_keys_match_exporter(trees, which):
    """state_dicts_from_jax gives the keys and shapes of tgsr_tpu's
    export_text_encoder / export_netg_low / export_netgh_weight, and they
    load strict=True into the port's modules."""
    _, tcfg, (text_v, netg_v, netgh_v) = trees
    i = ("text", "netg", "netgh").index(which)
    ref = (export_torch.export_text_encoder(text_v),
           export_torch.export_netg_low(netg_v),
           export_torch.export_netgh_weight(netgh_v))[i]
    got = state_dicts_from_jax(text_v, netg_v, netgh_v)[i]
    assert _shapes(got) == _shapes(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    module = _modules(tcfg)[i]
    module.load_state_dict(got, strict=True)
    assert _shapes(module.state_dict()) == _shapes(ref)


@pytest.mark.parametrize("unused", [False, True], ids=["jax-init", "with-unused"])
@pytest.mark.parametrize("which", ["netg", "netgh"])
def test_state_dict_keys_match_exporter_x16(which, unused):
    """The x16 family: state_dicts_from_jax of a GSRNetLow16 /
    NetGHighWeight16 tree gives the keys, shapes and values of tgsr_tpu's
    export_netg_low16 / export_netgh_weight16 (the aliased h_net2/3/4 and
    img_net1..4 key sets; residual816 and upscale16x where the tree carries
    them), and they load strict=True into the port's x16 modules."""
    jcfg, tcfg = configs(base_size=8, branch_num=5)
    trees = jax_trees16(jcfg, unused=unused)
    i = ("netg", "netgh").index(which)
    ref = (export_torch.export_netg_low16(trees[1]),
           export_torch.export_netgh_weight16(trees[2]))[i]
    sds = state_dicts_from_jax(*trees)
    got = sds[1 + i]
    assert _shapes(got) == _shapes(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    module = make_generators(tcfg, unused_blocks(sds[2]))[i]
    module.load_state_dict(got, strict=True)
    assert _shapes(module.state_dict()) == _shapes(ref)


def test_init_seeded_loads_strict_and_moves_bn():
    _, tcfg = configs()
    sds = init_seeded(tcfg, VOCAB, torch.Generator().manual_seed(0))
    for module, sd in zip(_modules(tcfg), sds[:3]):
        module.load_state_dict(sd, strict=True)
    var = [v for k, v in sds[1].items() if k.endswith("running_var")]
    mean = [v for k, v in sds[1].items() if k.endswith("running_mean")]
    assert all((v != 1).all() for v in var) and all((m != 0).all() for m in mean)
    again = init_seeded(tcfg, VOCAB, torch.Generator().manual_seed(0))
    assert all(torch.equal(sds[1][k], again[1][k]) for k in sds[1])


@pytest.mark.parametrize("name", _build.KERNELS)
def test_ctypes_signatures_match_sources(name):
    """The argtypes that `_build.library` sets name every extern "C"
    function of the kernel's source, with its number of parameters."""
    with open(_build.CSRC / f"{name}.cu") as f:
        src = f.read()
    found = {m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
             for m in re.finditer(r'extern "C"[^(]*?\b(\w+)\(([^)]*)\)', src)}
    want = {fn: len(argtypes) for fn, (argtypes, _) in _build.SIGNATURES[name].items()}
    assert found == want


HOST_LIBRARIES = ("png_unfilter", "jpeg_decode", "loader")


@pytest.mark.parametrize("name", HOST_LIBRARIES)
def test_host_ctypes_signatures_match_sources(name):
    """The argtypes `_build.host_library` sets name every exported (not
    static) function of the host source `csrc/<name>.c`, with its number of
    parameters, and the source includes no library header but the C
    standard library's (the card machine promises no libjpeg, libpng or
    zlib headers)."""
    with open(_build.CSRC / f"{name}.c") as f:
        src = f.read()
    found = {m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
             for m in re.finditer(r"^(?:int|void) (\w+)\(([^)]*)\)", src, re.M)}
    want = {fn: len(argtypes) for fn, (argtypes, _) in _build.SIGNATURES[name].items()}
    assert found == want
    headers = set(re.findall(r"#include <([^>]+)>", src))
    assert headers <= {"setjmp.h", "stdint.h", "stdio.h", "stdlib.h", "string.h"}, headers


def test_chip_smoke_alone_prints_no_result(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo must
    exit non-zero without its result line (here for want of a card, on a
    card for want of the package)."""
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
