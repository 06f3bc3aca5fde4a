"""The port's GANTrainer against tgsr_tpu's on the CPU, float32.

One JAX init (`GANTrainer.init_state`, jitted, built once for the module)
is carried into the port's state; both take the same numpy batches (three
captions: full, ragged, and one padded everywhere) and JAX's one-forward
step (`reuse_g_forward=True`, equal to its default, tests/test_remat.py:103).
Each JAX `GANTrainer` compiles its step for about 15 s, so each runs once
for the module. Gates, those `chip_smoke.py` holds the card to against the
CPU:

- metrics rtol 1e-4 (float sums in another order through about 30
  train-mode BNs, whose backward divides by the batch's own deviation);
- each gradient tensor (read from Adam's first moment: 0.5 g after one
  step) within relative L2 1e-4;
- BN running var within 1e-5 var, running mean within 1e-5 (|mean| +
  sqrt(var)): a mean near 0 has no relative precision, and is held at the
  spread of what it averages. Stats moved by a forward on parameters that an
  applied update moved (D's in the G step, G's after the first step) within
  1e-4 of the same: the entries at Adam's epsilon (below) part there;
- parameters and EMA within 1e-6, except entries whose gradient is below
  1e-6 max|g| of their tensor or whose Adam denominator sqrt(v_hat) is below
  1000 eps (1e-5): there Adam's step lr m_hat / (sqrt(v_hat) + eps) moves by
  lr eps dg / g^2 with a gradient error dg (at the first step every other
  entry moves by +-lr whatever its size). At most 1 % of the entries are
  excepted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.data.pipeline import device_preprocess as jax_preprocess
from tgsr_tpu.engine.gan_trainer import GANTrainer as JGANTrainer
from tgsr_tpu_torch.checkpoints.from_jax import text_state_dict
from tgsr_tpu_torch.data.pipeline import device_preprocess
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
from tests.torch_train_parity import (VOCAB, batch, flat, jax_batch, load_jax_opt,
                                      load_jax_state, port_trees, text_vars, train_configs)

torch.set_num_threads(1)
B, LENS = 3, (6, 3, 0)
METRIC_RTOL, GRAD_REL_L2, STATS_SCALE, PARAM_ATOL = 1e-4, 1e-4, 1e-5, 1e-6
ADAM_EPS = 1e-8  # optax.adam's and torch.optim.Adam's default


def jax_trees(js):
    """The JAX state's trees, numpy, keyed as `port_trees`."""
    js = jax.tree.map(np.asarray, js)
    opt = lambda o: (o.inner_opt_state if hasattr(o, "inner_opt_state") else o)[0]
    return {"g_params": js.g_params, "g_stats": js.g_stats, "g_ema": js.g_ema,
            "g_mu": opt(js.g_opt).mu, "g_nu": opt(js.g_opt).nu, "d_params": js.d_params,
            "d_stats": js.d_stats, "d_mu": opt(js.d_opt).mu, "d_nu": opt(js.d_opt).nu,
            "count": int(opt(js.g_opt).count)}


@pytest.fixture(scope="module")
def jax_init():
    """(JAX trainer, its initial state as numpy) of the tiny tree; the JAX
    init jitted once (13 s, against 37 s eagerly)."""
    jcfg, _ = train_configs()
    jt = JGANTrainer(jcfg, VOCAB, text_vars(), reuse_g_forward=True)
    js = jax.jit(lambda k: jt.init_state(k, B, init_on_cpu=False))(jax.random.PRNGKey(0))
    return jt, jax.tree.map(np.asarray, js)


def run_both(jax_init, steps, grad_accum=1, d_lr=None, restart=False):
    """(JAX metrics and trees after each step, port's), from one JAX init;
    `restart`: each port step after the first starts from JAX's state before
    it (weights, stats, Adam moments, EMA)."""
    jt0, js = jax_init
    jcfg, tcfg = train_configs()
    tv = text_vars()
    jt = (jt0 if grad_accum == 1 and d_lr is None else
          JGANTrainer(jcfg, VOCAB, tv, reuse_g_forward=True, grad_accum=grad_accum, d_lr=d_lr))
    js = js.replace(g_opt=jt.g_tx.init(js.g_params), d_opt=jt.d_tx.init(js.d_params))
    pt = GANTrainer(tcfg, VOCAB, text_state_dict(tv), grad_accum=grad_accum, d_lr=d_lr,
                    device="cpu")
    ps = pt.init_state(torch.Generator().manual_seed(0))
    load_jax_state(pt, ps, js)
    out = {"jax": [], "port": []}
    rng = jax.random.PRNGKey(2)
    for i in range(steps):
        b = batch(B, LENS, seed=i)
        if restart and i:
            load_jax_state(pt, ps, jax.tree.map(np.asarray, js))
            load_jax_opt(ps, out["jax"][-1][1])
        js, jm, rng = jt.train_step(js, jax_batch(b), rng)
        out["jax"].append(({k: float(v) for k, v in jm.items()}, jax_trees(js)))
        pm = pt.train_step(ps, b)
        out["port"].append(({k: float(v) for k, v in pm.items()}, port_trees(ps)))
    return out


@pytest.fixture(scope="module")
def accum_run(jax_init):
    return run_both(jax_init, 2, grad_accum=2)


def stats_failures(jt, pt, part, scale):
    """Running var within scale * var, running mean within scale * (|mean| +
    sqrt(var)): a mean near 0 is held at the spread of what it averages.
    The entries beyond their bound, as ("stats", part, tensor, index)."""
    fj, fp = flat(jt[part]), flat(pt[part])
    assert fj.keys() == fp.keys(), part
    out = []
    for k in fj:
        var = fj[k[:-len("mean")] + "var"] if k.endswith("/mean") else 0.0
        bound = scale * (np.abs(fj[k]) + np.sqrt(var))
        err = np.abs(fp[k] - fj[k])
        out += [("stats", part, k, tuple(map(int, i))) for i in np.argwhere(~(err <= bound))]
    return out


def check_stats(jt, pt, part, scale):
    fails = stats_failures(jt, pt, part, scale)
    assert not fails, fails[:10]


def gate_failures(jm, jt, pm, pt, g_moved=False):
    """Where one step's metrics, stats, gradients, params and EMA (`pm`, `pt`)
    leave the gates above around the reference's (`jm`, `jt`): ("metric",
    name), ("stats", ...), ("grad", net, tensor), ("param", tree, tensor,
    index), and ("cap", excepted, entries) where more than 1 % of the entries
    are excepted; `g_moved`: G's forward ran on parameters an earlier update
    moved."""
    assert set(pm) == set(jm), (sorted(pm), sorted(jm))
    fails = [("metric", k) for k in jm if not abs(pm[k] - jm[k]) <= METRIC_RTOL * abs(jm[k])]
    fails += stats_failures(jt, pt, "g_stats", STATS_SCALE * (10 if g_moved else 1))
    fails += stats_failures(jt, pt, "d_stats", STATS_SCALE * 10)
    bias = 1 - 0.999 ** max(jt["count"], 1)  # Adam's second-moment correction
    n_loose = [0, 0]
    for net in ("g", "d"):
        mu_j, mu_p, nu_j = flat(jt[f"{net}_mu"]), flat(pt[f"{net}_mu"]), flat(jt[f"{net}_nu"])
        assert mu_j.keys() == mu_p.keys()
        for k in mu_j:
            rel = np.linalg.norm(mu_p[k] - mu_j[k]) / max(np.linalg.norm(mu_j[k]), 1e-30)
            if not rel <= GRAD_REL_L2:
                fails.append(("grad", net, k))
            g = np.abs(mu_j[k])
            loose = (g < 1e-6 * g.max()) | (np.sqrt(nu_j[k] / bias) < 1000 * ADAM_EPS)
            n_loose[0] += loose.sum()
            n_loose[1] += loose.size
            for key in (f"{net}_params", "g_ema") if net == "g" else (f"{net}_params",):
                pj, pp = flat(jt[key])[k], flat(pt[key])[k]
                err = np.where(loose, 0.0, np.abs(pp - pj))
                fails += [("param", key, k, tuple(map(int, i)))
                          for i in np.argwhere(~(err <= PARAM_ATOL))]
    if n_loose[0] > 0.01 * n_loose[1]:  # the exception stays an exception
        fails.append(("cap", int(n_loose[0]), int(n_loose[1])))
    return fails


def check_step(jm, jt, pm, pt, g_moved=False):
    """One step at every gate above (`gate_failures`)."""
    fails = gate_failures(jm, jt, pm, pt, g_moved)
    assert not fails, fails[:10]


def test_one_step_matches_jax(jax_init):
    (jm, jt), (pm, pt) = (x[0] for x in run_both(jax_init, 1).values())
    check_step(jm, jt, pm, pt)


def test_two_steps_match_jax(jax_init):
    """Two steps, D's learning rate 0 on both sides, the port's second step
    from JAX's state after the first: G's second step (Adam's second moments
    and bias corrections, the EMA twice, BN stats on moved weights) at the
    gates above. Why not from the port's own first step, and why D frozen:
    the entries at Adam's epsilon that the first step excepts part by up to
    2 lr, and D's second Adam step moves its own such entries by amounts
    that turn on the last bits of their gradients; G's adversarial gradient
    read through either parts by 0.7-3.5 % in a tensor (measured here) while
    every metric agrees within 2e-5: the sensitivity of the adversarial
    coupling, not a difference of the programs (3e-5 with both removed).
    D's update is held by the one-step test and by grad_accum's applied
    step."""
    run = run_both(jax_init, 2, d_lr=0.0, restart=True)
    for step in (0, 1):
        (jm, jt), (pm, pt) = run["jax"][step], run["port"][step]
        check_step(jm, jt, pm, pt, g_moved=step == 1)


def test_grad_accum_matches_multisteps(accum_run):
    """grad_accum=2: nothing moves on the first micro-step (params and EMA as
    loaded; D's stats, moved by both its steps on the same D, at the tight
    gate); the second applies the mean of both gradients and blends the EMA
    once, as optax.MultiSteps with the EMA gated."""
    (jm0, jt0), (pm0, pt0) = accum_run["jax"][0], accum_run["port"][0]
    for k in jm0:
        np.testing.assert_allclose(pm0[k], jm0[k], rtol=METRIC_RTOL, err_msg=k)
    for part in ("g_params", "g_ema", "d_params"):
        for k, v in flat(jt0[part]).items():
            np.testing.assert_array_equal(flat(pt0[part])[k], v, err_msg=f"{part} {k}")
    check_stats(jt0, pt0, "g_stats", STATS_SCALE)
    check_stats(jt0, pt0, "d_stats", STATS_SCALE)
    (jm, jt), (pm, pt) = accum_run["jax"][1], accum_run["port"][1]
    check_step(jm, jt, pm, pt)


def test_bf16_step_close_to_f32():
    """compute_dtype bfloat16 against the port's float32 from one init: every
    state leaf stays float32 and each first-step metric above 1e-3 is within
    15 %, JAX's own gate (tests/test_gan_trainer_sharding.py:195-220)."""
    _, tcfg = train_configs()
    tv = text_state_dict(text_vars())
    b = batch(B, LENS)
    metrics = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = GANTrainer(tcfg, VOCAB, tv, compute_dtype=dtype, device="cpu")
        s = t.init_state(torch.Generator().manual_seed(0))
        metrics[dtype] = {k: float(v) for k, v in t.train_step(s, b).items()}
        leaves = [*s.netg.state_dict().values(), *s.netgh.state_dict().values(), s.a,
                  *s.dnets.state_dict().values(), *s.g_ema.values()]
        for opt in (s.g_opt, s.d_opt):
            leaves += [v for st in opt.state.values() for v in st.values() if v.dim()]
        assert all(x.dtype in (torch.float32, torch.int64) for x in leaves)
    for k, a in metrics[torch.float32].items():
        v = metrics[torch.bfloat16][k]
        assert np.isfinite(v), k
        if abs(a) > 1e-3:
            assert abs(a - v) / abs(a) < 0.15, (k, a, v)


def test_float64_reference_step():
    """compute_dtype float64 (the reference chip_smoke.py holds the card's
    float32 step against): the same step as float32 within rtol 1e-4 in
    every metric, float32 state."""
    _, tcfg = train_configs()
    tv = text_state_dict(text_vars())
    b = batch(B, LENS)
    metrics = {}
    for dtype in (torch.float32, torch.float64):
        t = GANTrainer(tcfg, VOCAB, tv, compute_dtype=dtype, device="cpu")
        s = t.init_state(torch.Generator().manual_seed(0))
        m = t.train_step(s, b)
        assert all(v.dtype == torch.promote_types(dtype, torch.float32) for v in m.values())
        metrics[dtype] = {k: float(v) for k, v in m.items()}
        assert all(p.dtype == torch.float32 for _, p in s.g_named_parameters())
    for k, v in metrics[torch.float32].items():
        np.testing.assert_allclose(metrics[torch.float64][k], v, rtol=1e-4, err_msg=k)


def test_loss_weights_scale_the_g_terms():
    """loss_weights: g_loss is the weighted sum of the unweighted terms the
    metrics report, and the weights change what G learns (the D step is
    the same)."""
    _, tcfg = train_configs()
    tv = text_state_dict(text_vars())
    b = batch(B, LENS)
    w = {"adv": 0.01, "pixel": 2.0, "kl": 0.5}
    runs = {}
    for tag, lw in (("plain", None), ("weighted", w)):
        t = GANTrainer(tcfg, VOCAB, tv, loss_weights=lw, device="cpu")
        s = t.init_state(torch.Generator().manual_seed(0))
        m = {k: float(v) for k, v in t.train_step(s, b).items()}
        runs[tag] = (m, [p.detach().clone() for _, p in s.g_named_parameters()])
    m = runs["weighted"][0]
    np.testing.assert_allclose(m["g_loss"], 0.01 * m["adv"] + 2.0 * m["pixel"] + 0.5 * m["kl"],
                               rtol=1e-6)
    np.testing.assert_allclose(m["d_loss"], runs["plain"][0]["d_loss"], rtol=1e-6)
    assert any(not torch.equal(a, b) for a, b in zip(runs["plain"][1], runs["weighted"][1]))
    with pytest.raises(ValueError, match="vgg"):
        GANTrainer(tcfg, VOCAB, tv, loss_weights={"vgg": 1.0}, device="cpu")


@pytest.mark.parametrize("with_blur", [False, True])
def test_device_preprocess_matches_jax(with_blur):
    hr = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    ref = jax_preprocess(jnp.asarray(hr), 4, 8, with_blur=with_blur)
    got = device_preprocess(torch.from_numpy(hr), 4, 8, with_blur=with_blur)
    assert sorted(got) == sorted(ref)
    for k in ref:
        for g, r in zip(got[k] if isinstance(got[k], list) else [got[k]],
                        ref[k] if isinstance(ref[k], list) else [ref[k]]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_x16_and_the_image_encoder_are_refused():
    """The families the port does not train are refused by name: BRANCH_NUM
    3 and a text encoder other than the LSTM and the GRU (the GRU trains:
    tests/test_torch_gru_paths.py; x16, BRANCH_NUM 5, trains:
    tests/test_torch_gan_trainer_x16.py); an image encoder that is not a
    DAMSM encoder module is refused (the DAMSM terms take a CNNEncoder or
    SimpleCNNEncoder, tests below)."""
    import dataclasses

    tv = text_state_dict(text_vars())
    _, tcfg = train_configs()
    _, tcfg3 = train_configs(branch_num=3)
    with pytest.raises(NotImplementedError, match="BRANCH_NUM = 3"):
        GANTrainer(tcfg3, VOCAB, tv, device="cpu")
    with pytest.raises(NotImplementedError, match="RNN_TYPE = 'RNN_TANH'"):
        GANTrainer(dataclasses.replace(tcfg, RNN_TYPE="RNN_TANH"), VOCAB, tv, device="cpu")
    _, tcfg16 = train_configs(branch_num=5)
    assert GANTrainer(tcfg16, VOCAB, tv, device="cpu").sizes == [8, 16, 32, 64]
    with pytest.raises(TypeError, match="CNNEncoder"):
        GANTrainer(tcfg, VOCAB, tv, image_encoder=lambda x: x, device="cpu")


def test_eval_metrics_match_jax(jax_init):
    """eval_metrics of the EMA generator: PSNR-Y and SSIM-Y on the batch's
    pyramid top, eval-mode BN."""
    jt, js = jax_init
    _, tcfg = train_configs()
    pt = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), device="cpu")
    ps = pt.init_state(torch.Generator().manual_seed(0))
    load_jax_state(pt, ps, js)
    b = batch(B, LENS, seed=5)
    jm = jt.eval_metrics(js.g_ema, js.g_stats, jax_batch(b))
    pm = pt.eval_metrics(ps, b)
    for k in ("psnr_y", "ssim_y"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    _, tcfg = train_configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()))


# -- the DAMSM terms (GANTrainer(image_encoder=...)) ---------------------------

DAMSM_CLASS_IDS = np.array([0, 1, 0], np.int32)  # a repeated class masks a negative


def encoder_pair(family):
    """(JAX module, its seeded tree as numpy, the port's module loaded with
    it) of one DAMSM image-encoder family at the tiny tree's nef."""
    from flax.core import unfreeze

    from tgsr_tpu.models import image_encoder as jie
    from tgsr_tpu_torch.checkpoints.from_jax import cnn_encoder_state_dict
    from tgsr_tpu_torch.models.image_encoder import make_image_encoder
    from tests.torch_parity import _perturb
    from tests.torch_train_parity import EMB

    jm = jie.SimpleCNNEncoder(nef=EMB) if family == "simple" else jie.CNNEncoder(nef=EMB)
    size = 64 if family == "simple" else 299
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, size, size, 3))))(jax.random.PRNGKey(3))
    v = _perturb(unfreeze(jax.tree.map(np.asarray, v)), np.random.default_rng(3))
    pm = make_image_encoder(family == "simple", EMB)
    pm.load_state_dict(cnn_encoder_state_dict(v), strict=True)
    return jm, v, pm


def damsm_batch(seed=0):
    """No empty caption: its words loss is the -1e9 sentinel's (about 1e9
    gamma3 / B) in both packages, which would bury the other terms."""
    return {**batch(B, (6, 3, 1), seed=seed), "class_ids": DAMSM_CLASS_IDS}


def test_damsm_terms_simple_cnn_match_jax(jax_init):
    """SimpleCNNEncoder's terms (w_loss, s_loss inside adv, their gradient
    into G through the finest fake) against JAX's GANTrainer(
    image_encoder_apply=...) on one step, at the gates of the one-step test;
    'damsm' 0.5 scales both terms as JAX's."""
    jt0, js = jax_init
    jcfg, tcfg = train_configs()
    jm, v, pm = encoder_pair("simple")
    jt = JGANTrainer(jcfg, VOCAB, text_vars(), image_encoder_apply=lambda img: jm.apply(v, img),
                     reuse_g_forward=True, loss_weights={"damsm": 0.5})
    js = js.replace(g_opt=jt.g_tx.init(js.g_params), d_opt=jt.d_tx.init(js.d_params))
    pt = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), image_encoder=pm,
                    loss_weights={"damsm": 0.5}, device="cpu")
    ps = pt.init_state(torch.Generator().manual_seed(0))
    load_jax_state(pt, ps, js)
    b = damsm_batch()
    js, jm_, _ = jt.train_step(js, jax_batch(b), jax.random.PRNGKey(2))
    pm_ = pt.train_step(ps, b)
    jmet = {k: float(v) for k, v in jm_.items()}
    pmet = {k: float(v) for k, v in pm_.items()}
    assert {"w_loss", "s_loss"} <= set(pmet)
    check_step(jmet, jax_trees(js), pmet, port_trees(ps))
    assert not any(p.grad is not None for p in pm.parameters())


def test_inception_damsm_terms_give_g_no_gradient(jax_init):
    """The Inception family's DAMSM terms add to G's loss and send G no
    gradient, in both packages: CNNEncoder's frozen backbone (JAX's
    default freeze_backbone, stop_gradient) cuts both backbone outputs
    from the graph, and the heads' inputs are all that the fake reaches. G's step with the terms equals
    the step without them (the port: bit for bit; JAX: to 1e-7 of each
    tensor's largest entry), while w_loss and s_loss agree between the
    packages (rtol 1e-4)."""
    jt0, js0 = jax_init
    jcfg, tcfg = train_configs()
    jm, v, pm = encoder_pair("inception")
    b = damsm_batch(seed=4)
    jruns, pruns = {}, {}
    for tag, enc in (("plain", None), ("inception", pm)):
        jt = (jt0 if enc is None else JGANTrainer(
            jcfg, VOCAB, text_vars(), image_encoder_apply=lambda img: jm.apply(v, img),
            reuse_g_forward=True))
        js = js0.replace(g_opt=jt.g_tx.init(js0.g_params), d_opt=jt.d_tx.init(js0.d_params))
        js, m, _ = jt.train_step(js, jax_batch(b), jax.random.PRNGKey(2))
        jruns[tag] = ({k: float(x) for k, x in m.items()}, jax_trees(js))
        pt = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), image_encoder=enc,
                        device="cpu")
        ps = pt.init_state(torch.Generator().manual_seed(0))
        load_jax_state(pt, ps, js0)
        m = pt.train_step(ps, b)
        pruns[tag] = ({k: float(x) for k, x in m.items()}, port_trees(ps))
    for k in ("w_loss", "s_loss"):
        np.testing.assert_allclose(pruns["inception"][0][k], jruns["inception"][0][k], rtol=1e-4)
    for runs, exact in ((pruns, True), (jruns, False)):
        (m0, t0), (m1, t1) = runs["plain"], runs["inception"]
        np.testing.assert_allclose(m1["g_loss"], m0["g_loss"] + m1["w_loss"] + m1["s_loss"],
                                   rtol=1e-5)
        for part in ("g_mu", "g_params"):
            for k, a in flat(t0[part]).items():
                got = flat(t1[part])[k]
                if exact:
                    np.testing.assert_array_equal(got, a, err_msg=f"{part} {k}")
                else:
                    np.testing.assert_allclose(got, a, rtol=0, atol=1e-7 * np.abs(a).max(),
                                               err_msg=f"{part} {k}")


def test_steps_run_with_tf32_off(monkeypatch):
    """train_step and super_resolve run with cuDNN's and cuBLAS's TF32
    switches off whatever the caller set, and leave them as they were."""
    import tgsr_tpu_torch.engine.gan_trainer as mod

    seen = []
    kl = mod.kl_loss
    monkeypatch.setattr(mod, "kl_loss", lambda *a: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)) or kl(*a))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _, tcfg = train_configs()
    t = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), device="cpu")
    s = t.init_state(torch.Generator().manual_seed(0))
    b = batch(B, LENS)
    t.train_step(s, b)
    forward = s.netg.forward

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return forward(*a, **kw)

    monkeypatch.setattr(s.netg, "forward", spy)
    t.super_resolve(s, b)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
