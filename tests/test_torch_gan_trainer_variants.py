"""The port's GANTrainer on the EVAL switches it trains, against tgsr_tpu's
GANTrainer on the CPU, float32: netGH's blurred-LR input ('lr-lrblur', the
blur taken in the step from the batch's LR, as JAX's `_g_forward`) and the
weight maps (EVAL.WEIGHTMAP: a1..a3, x16 a1..a4, netGH parameters under
Adam and the EMA; no trained `a`).

Each case carries one JAX init into the port and takes one step on both
sides from the same numpy batch. At the tiny trees of
tests/torch_train_parity.py ('lr-lrblur' x8, 'lrblur' with maps x16) the
step is held at the gates of tests/test_torch_gan_trainer.py (`check_step`:
metrics, gradients through Adam's first moment, BN stats, parameters and
EMA; the maps are parameter tensors there like any other).

The x8 maps are 64 / 128 / 256 px whatever the base size (JAX's trainer
passes no `sizes`), so the x8 map step runs at BASE_SIZE 32 (GF_DIM and
DF_DIM 16, B = 2). There a float32 step is ill-conditioned: JAX's own
float32 gradients lie up to 7.7e-2 (G) and 2.5e-2 (D) in relative L2 from
its float64 step (x64 on, the same state and batch), and the port's as far,
in other directions; so 1e-4 between the two float32 steps cannot hold, and
JAX's float64 step is the witness: every metric within 1e-4 of JAX's
float32 step, and each gradient tensor no farther from the float64 step than
1.5 times JAX's float32 step's distance (+ 1e-4 of its norm). A snapshot of
a map step writes a1..a3 (x16 a1..a4) and no `a`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.gan_trainer import GANTrainer as JGANTrainer
from tgsr_tpu_torch.checkpoints.from_jax import text_state_dict
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
from tests.test_torch_gan_trainer import check_step, jax_trees
from tests.torch_train_parity import (VOCAB, batch, flat, jax_batch, load_jax_state,
                                      port_trees, text_vars, train_configs)

torch.set_num_threads(1)
CASES = {  # name: (branch_num, width, base_size, INPUT_NETGH, WEIGHTMAP, batch size)
    "x8 lr-lrblur": (4, None, None, "lr-lrblur", False, 3),
    "x16 lrblur map": (5, 16, None, "lrblur", True, 2),
    "x8 lr-lrblur map": (4, 16, 32, "lr-lrblur", True, 2),
}
WITNESS_RATIO, WITNESS_FLOOR = 1.5, 1e-4


def _run(name, witness=False):
    """(JAX metrics, JAX trees, port metrics, port trees, port state) after
    one step from one JAX init; with `witness`, and JAX's float64 trees of
    the same step."""
    branch, width, base, low, wm, b = CASES[name]
    jcfg, tcfg = train_configs(branch, width=width, base_size=base, INPUT_NETGH=low,
                               WEIGHTMAP=wm)
    tv = text_vars()
    jt = JGANTrainer(jcfg, VOCAB, tv, reuse_g_forward=True)
    js = jax.jit(lambda k: jt.init_state(k, b, init_on_cpu=False))(jax.random.PRNGKey(0))
    js = jax.tree.map(np.asarray, js)
    if wm:  # the maps away from JAX's init of ones, so that an indexing fault shows
        rng = np.random.default_rng(1)
        maps = {k: (1 + rng.uniform(-0.5, 0.5, v.shape)).astype(np.float32)
                for k, v in js.g_params["netgh"].items() if k.startswith("a")}
        js = js.replace(g_params={**js.g_params, "netgh": {**js.g_params["netgh"], **maps}},
                        g_ema={**js.g_ema, "netgh": {**js.g_ema["netgh"], **maps}})
    pt = GANTrainer(tcfg, VOCAB, text_state_dict(tv), device="cpu")
    ps = pt.init_state(torch.Generator().manual_seed(0))
    load_jax_state(pt, ps, js)
    sizes = tcfg.pyramid_sizes()
    bt = batch(b, (6, 3, 0)[:b], seed=3, sizes=tuple(sizes))
    w64 = None
    if witness:
        with jax.enable_x64(True):
            jt64 = JGANTrainer(jcfg, VOCAB, tv, reuse_g_forward=True, compute_dtype=jnp.float64)
            w64 = jax_trees(jt64.train_step(js, jax_batch(bt), jax.random.PRNGKey(2))[0])
    js, jm, _ = jt.train_step(js, jax_batch(bt), jax.random.PRNGKey(2))
    pm = pt.train_step(ps, bt)
    return ({k: float(v) for k, v in jm.items()}, jax_trees(js),
            {k: float(v) for k, v in pm.items()}, port_trees(ps), ps, w64)


def _check_snapshot(ps, pt, maps):
    """The snapshot's netGH: the maps' EMA, no `a`."""
    _, netgh = ps.snapshot_variables()
    assert "a" not in netgh["params"]
    for k in maps:
        np.testing.assert_array_equal(netgh["params"][k], pt["g_ema"]["netgh"][k])


@pytest.mark.parametrize("name", ["x8 lr-lrblur", "x16 lrblur map"])
def test_step_matches_jax(name):
    branch, wm = CASES[name][0], CASES[name][4]
    jm, jt, pm, pt, ps, _ = _run(name)
    maps = sorted(k for k in jt["g_params"]["netgh"] if k.startswith("a"))
    assert maps == ({4: ["a1", "a2", "a3"], 5: ["a1", "a2", "a3", "a4"]}[branch] if wm
                    else ["a"])
    assert (ps.a is None) == wm
    check_step(jm, jt, pm, pt)
    if wm:
        _check_snapshot(ps, pt, maps)


def test_x8_map_step_against_float64_witness():
    """The x8 weight-map step at BASE_SIZE 32, with JAX's float64 step as the
    witness (module docstring)."""
    jm, jt, pm, pt, ps, w64 = _run("x8 lr-lrblur map", witness=True)
    assert sorted(k for k in pt["g_params"]["netgh"] if k.startswith("a")) == ["a1", "a2", "a3"]
    assert ps.a is None
    assert set(pm) == set(jm)
    for k in jm:
        assert abs(pm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pm[k], jm[k])
    far = []
    for net in ("g", "d"):
        ref, j32, p32 = (flat(t[f"{net}_mu"]) for t in (w64, jt, pt))
        assert ref.keys() == p32.keys()
        for k in ref:
            n = np.linalg.norm(ref[k])
            bound = WITNESS_RATIO * np.linalg.norm(j32[k] - ref[k]) + WITNESS_FLOOR * n
            if not np.linalg.norm(p32[k] - ref[k]) <= bound:
                far.append((net, k))
    assert not far, far[:10]
    _check_snapshot(ps, pt, ["a1", "a2", "a3"])
