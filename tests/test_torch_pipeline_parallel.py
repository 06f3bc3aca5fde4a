"""Pipeline parallelism of tgsr_tpu_torch (`parallel/pipeline.py`, GPipe over
ranks, send / recv between stages) against the sequential chain, as JAX's
tests/test_pipeline.py holds its `pipeline_apply`: over 2 and 4 gloo ranks on
the CPU (tests/torch_multirank_worker.py), NetGHighWeight's residual.0..5
(JAX's residual_0..5, carried across by `state_dicts_from_jax`) split into 1,
2 or 3 stages of consecutive blocks (a 2- or 3-stage mesh over the first
ranks of 4), the result on every rank of the stage mesh equal to the port's
sequential chain and to JAX's (rtol = atol = 1e-5, JAX's gate). JAX's
ValueErrors: blocks that do not split over the stages, a batch that does
not split into the microbatches, more stages than devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.ops.blocks import ResBlock as JResBlock
from tgsr_tpu.parallel.pipeline import extract_chain as jax_extract_chain
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.models.generator_hf import NetGHighWeight
from tgsr_tpu_torch.parallel.pipeline import extract_chain, stack_block_variables
from tests import torch_multirank_worker as ranks
from tests.torch_parity import VOCAB, configs, jax_trees

torch.set_num_threads(1)
NAMES = [f"residual.{i}" for i in range(6)]
# (world, stages, microbatches)
CASES = ((2, 2, 4), (2, 1, 2), (4, 2, 4), (4, 3, 2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg, VOCAB)
    ngf = tcfg.GAN.GF_DIM
    net = NetGHighWeight(ngf).eval()
    net.load_state_dict(state_dicts_from_jax(*trees)[2], strict=True)
    stacked = extract_chain(net, NAMES)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, ngf, 8, 8)).astype(np.float32))
    job = dict(kind="pipeline", ch=ngf, stacked=stacked, x=x)
    root = tmp_path_factory.mktemp("pipeline")
    handles = {}
    for world in (2, 4):
        jobs = [dict(job, stages=s, n_micro=m) for w, s, m in CASES if w == world]
        jobs += [dict(job, kind="raises", call="pipeline", stages=4 if world == 4 else 2,
                      n_micro=2 if world == 4 else 3),
                 dict(kind="raises", call="stage_mesh", stages=10_000)]
        handles[world] = ranks.start(jobs, world, root)
    with torch.no_grad():
        seq = x
        for name in NAMES:
            seq = net.get_submodule(name)(seq)
    netgh = trees[2]
    h = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    for i in range(6):
        v = {c: netgh[c][f"residual_{i}"] for c in netgh if f"residual_{i}" in netgh[c]}
        h = JResBlock(ngf).apply(v, h, False)
    return ({w: ranks.finish(hd) for w, hd in handles.items()}, seq,
            np.asarray(h).transpose(0, 3, 1, 2), trees, stacked)


@pytest.mark.parametrize("case", CASES)
def test_pipeline_equals_sequential_chain(runs, case):
    results, seq, jax_seq, _, _ = runs
    world, stages, n_micro = case
    i = [c for c in CASES if c[0] == world].index(case)
    for rank, r in enumerate(results[world]):
        if rank >= stages:
            assert r[i] is None  # not on the stage mesh
            continue
        np.testing.assert_allclose(r[i].numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[i].numpy(), jax_seq, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", (2, 4))
def test_pipeline_validation(runs, world):
    results, *_ = runs
    n = sum(c[0] == world for c in CASES)
    for rank, r in enumerate(results[world]):
        err = r[n]
        if world == 4:  # 6 blocks over 4 stages, on every rank of the mesh
            assert err == ("ValueError", "6 blocks do not split over 4 stages")
        elif rank < 2:  # a batch of 4 into 3 microbatches
            assert err == ("ValueError", "batch 4 not divisible by n_micro=3")
        assert r[n + 1] == ("ValueError", f"pipeline needs 10000 devices, have {world}")


def test_extract_chain_stacks_the_blocks_as_jax(runs):
    """The stacked chain holds JAX's stacked values (its HWIO kernels as the
    port's OIHW weights)."""
    *_, trees, stacked = runs
    ref = jax_extract_chain(trees[2], [f"residual_{i}" for i in range(6)])
    assert stacked["block.0.weight"].shape[0] == 6
    np.testing.assert_array_equal(stacked["block.0.weight"].numpy(), np.asarray(
        ref["params"]["conv1"]["kernel"]).transpose(0, 4, 3, 1, 2))
    np.testing.assert_array_equal(stacked["block.4.running_var"].numpy(),
                                  np.asarray(ref["batch_stats"]["bn2"]["var"]))
    with pytest.raises(ValueError, match="keys"):
        stack_block_variables([{"a": torch.zeros(1)}, {"b": torch.zeros(1)}])
    assert jax.default_backend() == "cpu"
