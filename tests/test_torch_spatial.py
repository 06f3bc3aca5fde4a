"""`SRPipeline.sr_spatial` of tgsr_tpu_torch (the image height split over the
mesh's 'data' axis, halos exchanged point to point: `parallel/spatial.py`)
over 2 and 4 gloo ranks on the CPU (tests/torch_multirank_worker.py),
against the port's unsharded forward and JAX's (tests/test_spatial_inference.py
holds JAX's own sr_spatial to its unsharded forward at the same gates). The
small geometry's 8 LR rows make 4 or 2 rows a shard; the blur of 'lrblur'
reads 4 rows on each side, so on 4 ranks its halo spans two neighbours.
Gates, JAX's: float32 rtol = atol = 2e-4 (every pyramid level and the
attention maps); int8 within one quant step of the unsharded int8 forward
(max < 0.02, mean < 1e-3) and >= 40 dB against JAX's; bfloat16 >= 50 dB. On
2 ranks also the weight maps with 'lr-lrblur' (BASE_SIZE 32, the maps' own
size: rows of the maps and of srb sliced with the sites' halos) and the
int8 UpBlocks by phases on halo tiles. An LR height that does not divide,
and no mesh, raise ValueError as JAX's does. Each op's halo comes from the
op itself (`row_halo`, `low_input_halo`); a module that holds a spatial
kernel and declares none raises."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, state_dicts_from_jax
from tgsr_tpu_torch.engine.inference import SRPipeline
from tgsr_tpu_torch.models.generator_hf import NetGHighWeight
from tgsr_tpu_torch.models.quantized import QuantConv, QuantUpBlock, QuantUpBlockPhases
from tgsr_tpu_torch.ops.blocks import ResBlock, UpBlock, UpBlockNoBN
from tgsr_tpu_torch.parallel import spatial
from tests import torch_multirank_worker as ranks
from tests.test_torch_fused_up_int8 import UP_SITES
from tests.test_torch_fused_upsample import psnr_u8
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]
WORLDS = (2, 4)
CASES = ("float32", "lrblur", "int8", "bfloat16", "int8 fused_up")


def _eval(cfg, **ev):
    return dataclasses.replace(cfg, EVAL=dataclasses.replace(cfg.EVAL, **ev))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    sds = state_dicts_from_jax(*trees)
    lr, cap, lens = inputs(2, jcfg.TREE.BASE_SIZE, T, [T, 2], seed=17)
    bf16 = dict(compute_dtype=torch.bfloat16)
    scales = SRPipeline(tcfg, VOCAB, *sds, device="cpu", **bf16).calibrate_quant(lr, cap, lens)
    setups = {"float32": (tcfg, dict(return_attn=True)),
              "lrblur": (_eval(tcfg, INPUT_NETGH="lrblur"), {}),
              "int8": (tcfg, dict(bf16, quant_scales=scales)),
              "bfloat16": (tcfg, bf16),
              "int8 fused_up": (tcfg, dict(bf16, quant_scales=scales, fused_up=UP_SITES))}
    t_in = tuple(torch.as_tensor(a) for a in (lr, cap, lens))
    jobs = [dict(kind="spatial", cfg=c, vocab=VOCAB, sds=sds, kw=kw, inputs=t_in)
            for c, kw in setups.values()]
    jobs.append(dict(kind="raises", call="spatial", cfg=tcfg, vocab=VOCAB, sds=sds,
                     inputs=(t_in[0][:, :7], *t_in[1:])))
    # weight maps at their own size (BASE_SIZE 32), blur input: two ranks
    mcfg = _eval(dataclasses.replace(tcfg, TREE=dataclasses.replace(tcfg.TREE, BASE_SIZE=32)),
                 INPUT_NETGH="lr-lrblur", WEIGHTMAP=True)
    msds = init_seeded(mcfg, VOCAB, torch.Generator().manual_seed(3))[:3]
    m_in = tuple(torch.as_tensor(a) for a in inputs(1, 32, T, [T], seed=19))
    root = tmp_path_factory.mktemp("spatial")
    handles = {2: ranks.start(jobs + [dict(kind="spatial", cfg=mcfg, vocab=VOCAB, sds=msds,
                                           inputs=m_in)], 2, root),
               4: ranks.start(jobs, 4, root)}
    refs = {name: SRPipeline(c, VOCAB, *sds, device="cpu", **kw)(lr, cap, lens)
            for name, (c, kw) in setups.items()}
    refs["maps"] = SRPipeline(mcfg, VOCAB, *msds, device="cpu")(*m_in)
    jax_refs = {name: JSRPipeline(c, VOCAB, *trees, **kw)(lr, cap, lens) for name, c, kw in (
        ("float32", jcfg, dict(return_attn=True)), ("lrblur", _eval(jcfg, INPUT_NETGH="lrblur"), {}),
        ("int8", jcfg, dict(compute_dtype=jnp.bfloat16, quant_scales=scales)))}
    no_mesh = SRPipeline(tcfg, VOCAB, *sds, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        no_mesh.sr_spatial(lr, cap, lens)
    return {w: ranks.finish(h) for w, h in handles.items()}, refs, jax_refs


def _check(name, got, ref, jref=None):
    for g, r in zip(got["pyramid"], ref["pyramid"]):
        g, r = g.numpy(), r.numpy()
        assert g.shape == r.shape
        if name in ("float32", "lrblur", "maps"):
            np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4)
        elif name == "bfloat16":
            assert psnr_u8(g, r) >= 50
        else:
            assert np.abs(g - r).max() < 0.02 and np.abs(g - r).mean() < 1e-3
    if jref is not None:
        for g, j in zip(got["pyramid"], jref["pyramid"]):
            if name.startswith("int8"):
                assert psnr_u8(g.numpy(), np.asarray(j)) >= 40
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CASES)
def test_sr_spatial_matches_unsharded_and_jax(runs, world, name):
    results, refs, jax_refs = runs
    i = CASES.index(name)
    first = results[world][0][i]
    for r in results[world][1:]:  # the whole result on every rank
        assert all(torch.equal(a, b) for a, b in zip(r[i]["pyramid"], first["pyramid"]))
    _check(name, first, refs[name], jax_refs.get(name))
    if name == "float32":
        for g, r, j in zip(first["attn"], refs[name]["attn"], jax_refs[name]["attn"]):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4)


def test_sr_spatial_weight_maps_and_blur_on_two_ranks(runs):
    results, refs, _ = runs
    for r in results[2]:
        _check("maps", r[len(CASES) + 1], refs["maps"])


@pytest.mark.parametrize("world", WORLDS)
def test_sr_spatial_height_must_divide(runs, world):
    results, _, _ = runs
    for r in results[world]:
        kind, msg = r[len(CASES)]
        assert kind == "ValueError" and "does not divide" in msg


class _FunctionalBlur(nn.Module):
    """A 3x3 depthwise blur held as a buffer and applied in functional code,
    with no `row_halo`: sharded rows would be wrong at every shard edge."""

    def __init__(self):
        super().__init__()
        self.register_buffer("k", torch.ones(3, 1, 3, 3) / 9)

    def forward(self, x):
        return F.conv2d(x, self.k, padding=1, groups=3)


def _conv(k):
    return nn.Conv2d(4, 8, k, padding=k // 2, bias=False)


@pytest.mark.parametrize("make, rule", [
    (lambda: UpBlock(4, 4), (1, 2)), (lambda: UpBlock(4, 4, fused=True), (1, 2)),
    (lambda: UpBlockNoBN(4, 4), (1, 2)), (lambda: _conv(5), (2, 1)), (lambda: _conv(1), None),
    (lambda: QuantConv(_conv(3), 1.0, torch.float32), (1, 1)),
    (lambda: QuantUpBlock(UpBlock(4, 4).eval(), 1.0), (1, 2)),
    (lambda: QuantUpBlockPhases(UpBlock(4, 4).eval(), 1.0), (1, 2)),
    (lambda: ResBlock(4), None), (lambda: nn.MaxPool2d(2), NotImplementedError),
    (lambda: _FunctionalBlur(), NotImplementedError),
], ids=["UpBlock", "UpBlock_fused", "UpBlockNoBN", "Conv2d_5x5", "Conv2d_1x1", "QuantConv",
        "QuantUpBlock", "QuantUpBlockPhases", "ResBlock_walked", "pool_raises",
        "undeclared_kernel_raises"])
def test_halo_rules_come_from_the_modules(make, rule):
    """(halo, output rows a source row) as each module declares it (torch's
    Conv2d from its kernel; None: its children are walked); a module that
    declares none and holds a 4-D weight or buffer raises, as pooling does."""
    if rule is NotImplementedError:
        with pytest.raises(NotImplementedError, match="sr_spatial"):
            spatial._halo_of(make())
    else:
        assert spatial._halo_of(make()) == rule


@pytest.mark.parametrize("low, halo", [("lr", 0), ("lrblur", 4), ("lr-lrblur", 4)])
def test_hf_input_declares_its_halo(low, halo):
    """The HF branch's input reads the blur's half support (4 rows at
    radius 2) each way, and nothing beside 'lr'."""
    assert NetGHighWeight(8, n_res=1, low=low).low_input_halo == halo
