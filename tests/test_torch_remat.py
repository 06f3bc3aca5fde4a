"""Rematerialisation in the port's trainer (`utils/remat.py`, JAX's
`remat` False / True / 'all' / 'low' / 'high').

Remat changes memory only: a remat step gives the metrics, parameters, EMA,
Adam moments, BN running stats and num_batches_tracked of the step without
it, bit for bit on the CPU, for both families, in float32 and in bfloat16
(where the recompute runs on the call's bfloat16 weights). JAX's own test
holds its remat step within 1e-5 (tests/test_remat.py:52-101,
tests/test_gan_trainer_x16.py:83); the port's x16 'all' step is also held
against JAX's remat='all' step at the x8 parity gates. The x16 tree is JAX's
own (GF_DIM 8, DF_DIM 8), but 16 where held against JAX. The recompute does
not move BN's running stats a second time; the control shows that this is
the guard's doing.
"""
import jax
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.gan_trainer import GANTrainer as JGANTrainer
from tgsr_tpu_torch.checkpoints.from_jax import text_state_dict
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
from tgsr_tpu_torch.models.models16 import make_generators
from tgsr_tpu_torch.utils import remat as remat_mod
from tests.test_torch_gan_trainer import check_step, jax_trees
from tests.torch_train_parity import (VOCAB, batch, jax_batch, load_jax_state, port_trees,
                                      text_vars, train_configs)

torch.set_num_threads(1)
SIZES = {4: (16, 32, 64), 5: (8, 16, 32, 64)}
LENS = (6, 3, 0)


def step(branch_num, remat, dtype=torch.float32, steps=1):
    """The port's state after `steps` steps from seed 0 on seeded batches:
    (metrics of the last, every state tensor by name)."""
    _, tcfg = train_configs(branch_num=branch_num)
    t = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), compute_dtype=dtype, remat=remat,
                   device="cpu")
    s = t.init_state(torch.Generator().manual_seed(0))
    for i in range(steps):
        m = t.train_step(s, batch(3, LENS, seed=i, sizes=SIZES[branch_num]))
    tensors = {f"{k}.{n}": v for k, mod in (("netg", s.netg), ("netgh", s.netgh),
                                            ("d", s.dnets))
               for n, v in mod.state_dict().items()}
    tensors.update({f"ema.{n}": v for n, v in s.g_ema.items()})
    for tag, opt in (("g", s.g_opt), ("d", s.d_opt)):
        for i, st in enumerate(opt.state.values()):
            tensors.update({f"{tag}_opt.{i}.{k}": v for k, v in st.items()})
    return {k: v.detach() for k, v in m.items()}, tensors


@pytest.fixture(scope="module")
def plain_steps():
    """The remat=False runs, one per (family, dtype)."""
    return {(bn, dt): step(bn, False, dt, steps=2) for bn in (4, 5)
            for dt in (torch.float32, torch.bfloat16)}


def assert_same(a, b):
    (ma, ta), (mb, tb) = a, b
    assert ma.keys() == mb.keys() and ta.keys() == tb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("branch_num", [4, 5])
@pytest.mark.parametrize("policy", [True, "all", "low", "high"])
def test_remat_step_equals_the_plain_step(plain_steps, branch_num, policy):
    """Two float32 steps (the second on moved weights, Adam's second
    moments) under each policy: every metric and state tensor bit for bit,
    BN running stats and num_batches_tracked included."""
    assert_same(step(branch_num, policy, steps=2), plain_steps[branch_num, torch.float32])


@pytest.mark.parametrize("branch_num", [4, 5])
def test_bf16_remat_recomputes_on_the_cast_weights(plain_steps, branch_num):
    """bfloat16 (call_cast swaps bfloat16 copies in for the call; the
    recompute, after the call has returned, runs on those copies, not on the
    float32 masters): 'all' equals the step without remat bit for bit, and
    the state stays float32."""
    got = step(branch_num, "all", torch.bfloat16, steps=2)
    assert_same(got, plain_steps[branch_num, torch.bfloat16])
    assert all(v.dtype in (torch.float32, torch.int64) for v in got[1].values())


@pytest.mark.parametrize("branch_num", [4, 5])
def test_the_bn_guard_is_what_keeps_the_stats(plain_steps, monkeypatch, branch_num):
    """The control: with `recomputing()` always false, the recompute blends
    the running stats again, so they (and num_batches_tracked) part from the
    plain step's, while the metrics and parameters do not (train-mode BN's
    output reads the batch's moments only)."""
    monkeypatch.setattr(remat_mod, "recomputing", lambda: False)
    m, t = step(branch_num, "all", steps=2)
    m0, t0 = plain_steps[branch_num, torch.float32]
    for k in m0:
        assert torch.equal(m[k], m0[k]), k
    stats = [k for k in t0 if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    moved = [k for k in stats if not torch.equal(t[k], t0[k])]
    assert moved and all(k.startswith(("netg.", "netgh.")) for k in moved)
    assert not any(k.startswith("d.") for k in moved)
    params = [k for k in t0 if k.startswith("ema.")]
    assert all(torch.equal(t[k], t0[k]) for k in params)


def test_x16_remat_all_matches_jax_remat_all():
    """The port's remat='all' x16 step against JAX's remat='all' step from
    one JAX init, at the gates of the x8 parity test and its width (16, as
    tests/test_torch_gan_trainer_x16.py; the port's remat steps equal its
    plain steps bit for bit, and those are held at width 8 in
    tests/test_torch_gan_trainer_x16_width8.py)."""
    jcfg, tcfg = train_configs(branch_num=5, width=16)
    jt = JGANTrainer(jcfg, VOCAB, text_vars(), reuse_g_forward=True, remat="all")
    js = jax.tree.map(np.asarray, jax.jit(lambda k: jt.init_state(k, 2, init_on_cpu=False))(
        jax.random.PRNGKey(0)))
    pt = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), remat="all", device="cpu")
    ps = pt.init_state(torch.Generator().manual_seed(0))
    load_jax_state(pt, ps, js)
    b = batch(2, (6, 0), sizes=SIZES[5])
    js, jm, _ = jt.train_step(js, jax_batch(b), jax.random.PRNGKey(2))
    pm = pt.train_step(ps, b)
    check_step({k: float(v) for k, v in jm.items()}, jax_trees(js),
               {k: float(v) for k, v in pm.items()}, port_trees(ps))


def test_policies_and_what_they_remat():
    """'low' rematerialises GSRNetLow's stages, 'high' NetGHighWeight's
    blocks, True and 'all' both; anything else raises JAX's ValueError.
    Outside autograd `remat` is a plain call (serving, eval)."""
    _, tcfg = train_configs(branch_num=5)
    for policy, want in ((False, (False, False)), (True, (True, True)), ("all", (True, True)),
                         ("low", (True, False)), ("high", (False, True))):
        netg, netgh = make_generators(tcfg, remat=policy)
        assert (netg.remat, netgh.remat) == want == remat_mod.remat_policy(policy)
    for bad in ("bogus", "ALL", None):
        with pytest.raises(ValueError, match="remat must be False/True/'all'/'low'/'high'"):
            remat_mod.remat_policy(bad)
    calls = []
    block = torch.nn.Sequential(torch.nn.Conv2d(2, 2, 1), torch.nn.Tanh(), torch.nn.Conv2d(2, 2, 1))
    block[0].register_forward_hook(lambda *a: calls.append(remat_mod.recomputing()))
    x = torch.randn(1, 2, 3, 3, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(remat_mod.remat(block, x), block(x))
    remat_mod.remat(block, x).sum().backward()
    assert calls == [False, False, False, True]  # two no_grad calls, the forward, its recompute
    assert not remat_mod.recomputing()
