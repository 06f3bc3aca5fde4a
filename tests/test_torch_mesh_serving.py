"""Mesh serving of tgsr_tpu_torch (`SRPipeline(mesh=...)`, the counterpart of
tgsr_tpu's DP serving, tests/test_mesh_inference.py) over 2 and 4 gloo ranks
on the CPU (tests/torch_multirank_worker.py, one process a rank): each rank
runs its rows of the batch (3 images: padded by a replica on 2 ranks, by one
on 4) and `__call__`, `forward_scan` and `sr_batched` return the whole batch
in order on every rank, the same on each. Gates, those of JAX's tests:
float32 rtol = atol = 2e-4 against the port's unsharded forward and against
JAX's; bfloat16 >= 50 dB against both (the bf16 tests' gate); int8 within one
quant step of the port's unsharded int8 forward (max < 0.02, mean < 1e-3) and
>= 40 dB against JAX's; the uint8 SR of `forward_scan` / `sr_batched` within
1 level (float32), at >= 50 dB (bfloat16) or 3 levels (int8: one step, 0.02
x 127.5) of the unsharded forward_scan. With no microbatch given, the ranks
agree on the least of their memory plans."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests import torch_multirank_worker as ranks
from tests.test_torch_fused_upsample import psnr_u8
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]
PATHS = ("float32", "bfloat16", "int8")
WORLDS = (2, 4)
SCAN_M = 2
# each rank's own microbatch plan in the "plan" job: rank 0's 1 makes sr_batched
# run 2 x 2 on 2 ranks, where rank 1's 4 alone would run 1 x 3
PLANS = (1, 4, 2, 3)


def _kw(path, scales):
    if path == "float32":
        return {}
    return dict(compute_dtype=torch.bfloat16, **({"quant_scales": scales} if path == "int8" else {}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    sds = state_dicts_from_jax(*trees)
    lr, cap, lens = inputs(3, jcfg.TREE.BASE_SIZE, T, [T, 2, 0], seed=13)
    scales = SRPipeline(tcfg, VOCAB, *sds, device="cpu", compute_dtype=torch.bfloat16
                        ).calibrate_quant(lr, cap, lens)
    lr_u8 = np.round((lr + 1.0) * 127.5).astype(np.uint8)
    t_in = tuple(torch.as_tensor(a) for a in (lr, cap, lens))
    jobs = [dict(kind="mesh", cfg=tcfg, vocab=VOCAB, sds=sds, kw=_kw(p, scales), inputs=t_in,
                 scan_m=SCAN_M, lr_u8=lr_u8, microbatch=64) for p in PATHS]
    jobs.append(dict(kind="plan", cfg=tcfg, vocab=VOCAB, sds=sds, inputs=t_in, lr_u8=lr_u8,
                     plans=PLANS))
    root = tmp_path_factory.mktemp("mesh")
    handles = {w: ranks.start(jobs, w, root) for w in WORLDS}
    # the references while the ranks run
    refs = {}
    for p in PATHS:
        port = SRPipeline(tcfg, VOCAB, *sds, device="cpu", **_kw(p, scales))
        jkw = {} if p == "float32" else dict(compute_dtype=jnp.bfloat16, **(
            {"quant_scales": scales} if p == "int8" else {}))
        jpipe = JSRPipeline(jcfg, VOCAB, *trees, **jkw)
        refs[p] = dict(port=port(lr, cap, lens), jax=jpipe(lr, cap, lens),
                       scan=port.forward_scan(lr_u8[None].repeat(SCAN_M, 0),
                                              cap[None].repeat(SCAN_M, 0),
                                              lens[None].repeat(SCAN_M, 0)))
    return {w: ranks.finish(h) for w, h in handles.items()}, refs


def _same_on_every_rank(results, i, key):
    first = results[0][i][key]
    for r in results[1:]:
        got = r[i][key]
        if isinstance(first, dict):
            assert all(torch.equal(a, b) for a, b in zip(got["pyramid"], first["pyramid"]))
        else:
            assert torch.equal(got, first)
    return first


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", PATHS)
def test_mesh_call_matches_unsharded_and_jax(runs, world, path):
    results, refs = runs
    got = _same_on_every_rank(results[world], PATHS.index(path), "call")
    ref = refs[path]
    assert len(got["pyramid"]) == 3 and got["sr"].shape == (3, 64, 64, 3)
    for g, p, j in zip(got["pyramid"], ref["port"]["pyramid"], ref["jax"]["pyramid"]):
        g, p, j = g.numpy(), p.numpy(), np.asarray(j)
        if path == "float32":
            np.testing.assert_allclose(g, p, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(g, j, rtol=2e-4, atol=2e-4)
        elif path == "bfloat16":
            assert psnr_u8(g, p) >= 50 and psnr_u8(g, j) >= 50
        else:
            assert np.abs(g - p).max() < 0.02 and np.abs(g - p).mean() < 1e-3
            assert psnr_u8(g, j) >= 40


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", PATHS)
def test_mesh_scan_and_batched_match_unsharded(runs, world, path):
    results, refs = runs
    i = PATHS.index(path)
    scan = _same_on_every_rank(results[world], i, "scan")
    batched = _same_on_every_rank(results[world], i, "batched")
    ref = refs[path]["scan"]
    assert scan.shape == ref.shape == (SCAN_M, 3, 64, 64, 3) and scan.dtype == torch.uint8
    for got in (scan[0], scan[1], batched):
        d = (got.int() - ref[0].int()).abs()
        if path == "float32":
            assert d.max() <= 1
        elif path == "bfloat16":
            assert psnr_u8(got.numpy() / 127.5 - 1, ref[0].numpy() / 127.5 - 1) >= 50
        else:
            assert d.max() <= 3


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_plan_is_agreed_by_the_ranks(runs, world):
    """`plan_microbatch` under a mesh is the least of the ranks' own plans on
    every rank, so `sr_batched` with no microbatch runs one shape on all of
    them and returns the whole batch; a plan that fails on one rank raises
    on every rank."""
    results, refs = runs
    i = len(PATHS)
    assert [r[i]["plan"] for r in results[world]] == [min(PLANS[:world])] * world
    batched = _same_on_every_rank(results[world], i, "batched")
    assert batched.shape == (3, 64, 64, 3)
    assert (batched.int() - refs["float32"]["scan"][0].int()).abs().max() <= 1
    for r in results[world]:
        assert "does not fit the card of every rank" in r[i]["fault"]
