"""The port's DAMSMTrainer (tgsr_tpu_torch/engine/damsm_trainer.py) against
tgsr_tpu's on the CPU, float32, SimpleCNNEncoder at 32 px (nef 32, T 6,
vocab 12, B 4; the JAX init jitted once and carried across), dropout at 0
on both sides (the JAX module's drop_prob cloned to 0; the port's set).

Gates, those of tests/test_torch_gan_trainer.py for an Adam step, the
gradients held against JAX's own step in float64 (x64 on: JAX's text
encoder, CNN and losses as its `_loss` composes them, without the casts
of the CNN's outputs to float32):
- metrics rtol 1e-4 (the text-gradient norm included);
- the port's step in float64 equals JAX's in float64: each gradient
  tensor within relative L2 1e-6 (both rounded to float32 to compare), so
  the two programs compute the same maths;
- each float32 gradient tensor (read from Adam's moments) within relative
  L2 1e-4 of JAX's, or within 1e-4 more of JAX's float64 gradient than the
  farther of two float32 roundings puts it: JAX's float32 step, and the
  float64 step on the image resized in float32. SimpleCNN's first layers
  (conv0, bn0, conv1, bn1's bias) are ill-conditioned in the 32 -> 137 px
  resize at this geometry: the port's float32 matrix moves them 6e-4 to
  1.1e-3 off float64, and JAX's (the same weights but for 1-ulp
  differences) 1e-6; JAX's float32 step is 1.2e-4 to 2e-4 off. JAX's
  distance is itself held within 1e-2;
- the CNN's BN running stats within 1e-5 (|mean| + sqrt(var)) / 1e-5 var;
- parameters within 1e-6, off the entries whose gradient is below 1e-6
  max |g| of their tensor, whose Adam denominator is below 1000 eps, or
  whose gradient has the other sign in the two packages: Adam's first
  step moves every entry by +-lr whatever its size, the sign of its
  gradient. At most 1 % are excepted.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgsr_tpu import config as jcfg_mod
from tgsr_tpu.engine.damsm_trainer import DAMSMTrainer as JDAMSMTrainer
from tgsr_tpu.losses.damsm import sent_loss as jax_sent_loss
from tgsr_tpu.losses.damsm import words_loss as jax_words_loss
from tgsr_tpu_torch import config as tcfg_mod
from tgsr_tpu_torch.checkpoints.from_jax import (cnn_encoder_state_dict, cnn_encoder_variables,
                                                 text_state_dict, text_variables)
from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer
from tgsr_tpu_torch.losses.damsm import sent_loss, words_loss
from tgsr_tpu_torch.models.image_encoder import SIMPLE_SIZE
from tgsr_tpu_torch.models.text_encoder import dropout
from tgsr_tpu_torch.ops.image import resize
from tests.torch_train_parity import flat

torch.set_num_threads(1)
VOCAB, T, EMB, B, SIZE = 12, 6, 32, 4, 32
LENS = (6, 3, 1, 5)
METRIC_RTOL, GRAD_REL_L2, STATS_SCALE, PARAM_ATOL, ADAM_EPS = 1e-4, 1e-4, 1e-5, 1e-6, 1e-8
F64_REL_L2 = 1e-6


def damsm_configs(lr=2e-4, clip=0.25):
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        cfg = mod.Config()
        out.append(dataclasses.replace(
            cfg, TEXT=dataclasses.replace(cfg.TEXT, EMBEDDING_DIM=EMB, WORDS_NUM=T),
            TRAIN=dataclasses.replace(cfg.TRAIN, ENCODER_LR=lr, RNN_GRAD_CLIP=clip)))
    return tuple(out)


def host_batch(seed=0, b=B, lens=LENS):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, VOCAB, (b, T)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for i, n in enumerate(lens):
        caps[i, n:] = 0
    return {"hr": rng.integers(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8), "captions": caps,
            "cap_lens": lens, "class_ids": np.arange(b, dtype=np.int32)}


def jax_state_trees(js):
    js = jax.tree.map(np.asarray, js)
    adam = js.opt_state.inner_state[0]
    return {"text": js.text_params, "cnn": js.cnn_params, "stats": js.cnn_stats,
            "mu": adam.mu, "nu": adam.nu, "count": int(adam.count)}


def as_trees(ps, values):
    """{"text": ..., "cnn": ...} JAX-shaped param trees of `values` (name ->
    tensor, the trainer's `trainable` names), the rest from `ps`."""
    text_sd = {k[5:]: v for k, v in values.items() if k.startswith("text.")}
    cnn_sd = dict(ps.cnn.state_dict())
    cnn_sd.update({k[4:]: v for k, v in values.items() if k.startswith("cnn.")})
    return {"text": text_variables(text_sd)["params"],
            "cnn": cnn_encoder_variables(cnn_sd)["params"]}


def port_state_trees(trainer, ps):
    text, cnn = ps.snapshot_variables()
    named = dict(trainer.trainable(ps.text, ps.cnn))
    mu = {n: ps.opt.state[p]["exp_avg"] if p in ps.opt.state else torch.zeros_like(p)
          for n, p in named.items()}
    return {"text": text["params"], "cnn": cnn["params"], "stats": cnn["batch_stats"],
            "mu": as_trees(ps, mu)}


def float64_grads(trainer, ps, batch, resize_in_float32=False):
    """The step's clipped gradient trees from the port's program in float64
    on a copy of `ps` (train mode, dropout as set); `resize_in_float32`:
    on the image resized to SimpleCNN's input in float32, as the float32
    step resizes it."""
    text, cnn = copy.deepcopy(ps.text).double(), copy.deepcopy(ps.cnn).double()
    text.train()
    cnn.train()
    names, params = zip(*trainer.trainable(text, cnn))
    imgs = batch["imgs"]
    if resize_in_float32:
        imgs = resize(imgs, (SIMPLE_SIZE, SIMPLE_SIZE), "bilinear")
    feat, code = cnn(imgs.double())
    words, sent = text(batch["captions"], batch["cap_lens"])
    g1, g2, g3 = trainer.gammas
    w0, w1, _ = words_loss(feat, words, batch["cap_lens"], batch["class_ids"], g1, g2, g3)
    s0, s1 = sent_loss(code, sent, batch["class_ids"], g3)
    grads = torch.autograd.grad(w0 + w1 + s0 + s1, params)
    n_text = sum(n.startswith("text.") for n in names)
    tnorm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads[:n_text]])))
    scale = min(1.0, trainer.grad_clip / max(tnorm, 1e-12))
    return as_trees(ps, {n: (g * scale if i < n_text else g).float()
                         for i, (n, g) in enumerate(zip(names, grads))})


def jax_float64_grads(jt, js, b):
    """JAX's clipped step gradients in float64 (x64 on) at state `js` on
    host batch `b`, rounded to float32 trees {"text", "cnn"}."""
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        params = f64({"text": js.text_params, "cnn": js.cnn_params})
        stats = f64(js.cnn_stats)
        db = dict(jt._device_batch(b, None))
        db["imgs"] = jnp.asarray(db["imgs"], jnp.float64)

        def loss(p):
            (feat, code), _ = jt.cnn_encoder.apply(
                {"params": p["cnn"], "batch_stats": stats}, db["imgs"], train=True,
                mutable=["batch_stats"])
            words, sent = jt.text_encoder.apply({"params": p["text"]}, db["captions"],
                                                db["cap_lens"], train=True)
            g1, g2, g3 = (jt.cfg.TRAIN.SMOOTH.GAMMA1, jt.cfg.TRAIN.SMOOTH.GAMMA2,
                          jt.cfg.TRAIN.SMOOTH.GAMMA3)
            w0, w1, _ = jax_words_loss(feat, words, db["cap_lens"], db["class_ids"], g1, g2, g3)
            s0, s1 = jax_sent_loss(code, sent, db["class_ids"], g3)
            return w0 + w1 + s0 + s1

        g = jax.jit(jax.grad(loss))(params)
        assert {x.dtype for x in jax.tree.leaves(g)} == {jnp.dtype(jnp.float64)}
        tnorm = optax.global_norm(g["text"])
        scale = jnp.minimum(1.0, jt.grad_clip / jnp.maximum(tnorm, 1e-12))
        g["text"] = jax.tree.map(lambda x: x * scale, g["text"])
        return jax.tree.map(lambda x: np.asarray(x, np.float32), g)


@pytest.fixture(scope="module")
def jax_init():
    jcfg, _ = damsm_configs()
    jt = JDAMSMTrainer(jcfg, VOCAB, use_inception=False)
    js = jax.jit(lambda k: jt.init_state(k, SIZE, B, init_on_cpu=False))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, js)


def load_jax(pt, ps, jtree):
    """A JAX state's trees (`jax_state_trees`) into the port's state:
    weights, stats, Adam's moments and count."""
    pt.load_state(ps, text_state_dict({"params": jtree["text"]}),
                  cnn_encoder_state_dict({"params": jtree["cnn"], "batch_stats": jtree["stats"]}))
    moments = {}
    for key in ("mu", "nu"):
        t = text_state_dict({"params": jtree[key]["text"]})
        c = cnn_encoder_state_dict({"params": jtree[key]["cnn"], "batch_stats": jtree["stats"]})
        moments[key] = {**{f"text.{k}": v for k, v in t.items()},
                        **{f"cnn.{k}": v for k, v in c.items()}}
    step = torch.tensor(float(jtree["count"]))
    for n, p in pt.trainable(ps.text, ps.cnn):
        ps.opt.state[p] = {"step": step.clone(),
                           "exp_avg": moments["mu"][n].reshape(p.shape).clone(),
                           "exp_avg_sq": moments["nu"][n].reshape(p.shape).clone()}


def run_both(js, steps, lr=2e-4, clip=0.25):
    """(JAX, port) metrics and trees after each step from one init; each
    port step after the first starts from JAX's state before it."""
    jcfg, tcfg = damsm_configs(lr, clip)
    jt = JDAMSMTrainer(jcfg, VOCAB, use_inception=False)
    jt.text_encoder = jt.text_encoder.clone(drop_prob=0.0)
    pt = DAMSMTrainer(tcfg, VOCAB, use_inception=False, device="cpu")
    ps = pt.init_state(torch.Generator().manual_seed(0))
    pt.load_state(ps, text_state_dict({"params": js.text_params}),
                  cnn_encoder_state_dict({"params": js.cnn_params, "batch_stats": js.cnn_stats}))
    ps.text.drop_prob = 0.0
    js = jax.tree.map(jnp.asarray, js)
    out = {"jax": [], "port": []}
    for i in range(steps):
        b = host_batch(i)
        g64 = {"jax": jax_float64_grads(jt, js, b)}
        js, jm = jt.train_step(js, jt._device_batch(b, None), lr, jax.random.PRNGKey(i))
        out["jax"].append(({k: float(v) for k, v in jm.items()}, jax_state_trees(js)))
        if i:
            load_jax(pt, ps, out["jax"][i - 1][1])
        db = pt.device_batch(b)
        g64["port"] = float64_grads(pt, ps, db)
        g64["resize f32"] = float64_grads(pt, ps, db, resize_in_float32=True)
        pm = pt.train_step(ps, db, lr)
        out["port"].append(({k: float(v) for k, v in pm.items()}, port_state_trees(pt, ps), g64))
    return out


def step_grads(run, step):
    """Each package's gradient trees of step `step` from Adam's first
    moments: g_k = (mu_k - b1 mu_(k-1)) / (1 - b1), both from JAX's
    mu_(k-1) (the port's step k starts from it)."""
    out = []
    for tag in ("jax", "port"):
        mu = run[tag][step][1]["mu"]
        prev = run["jax"][step - 1][1]["mu"] if step else jax.tree.map(np.zeros_like, mu)
        out.append(jax.tree.map(lambda m, p: (np.asarray(m) - 0.5 * np.asarray(p)) / 0.5,
                                mu, prev))
    return out


def check_step(jm, jt, pm, pt, g_jax, g_port, g64):
    assert set(pm) == set(jm) == {"w_loss", "s_loss", "loss", "rnn_grad_norm"}
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=METRIC_RTOL, err_msg=k)
    fj, fp = flat(jt["stats"]), flat(pt["stats"])
    assert fj.keys() == fp.keys()
    for k in fj:
        var = fj[k[:-len("mean")] + "var"] if k.endswith("/mean") else 0.0
        err = np.abs(fp[k] - fj[k])
        assert (err <= STATS_SCALE * (np.abs(fj[k]) + np.sqrt(var))).all(), (k, err.max())
    bias = 1 - 0.999 ** jt["count"]
    n_loose = [0, 0]
    for part in ("text", "cnn"):
        gj, gp, g8 = flat(g_jax[part]), flat(g_port[part]), flat(g64["jax"][part])
        p8, r8 = flat(g64["port"][part]), flat(g64["resize f32"][part])
        nu_j, pj, pp = flat(jt["nu"][part]), flat(jt[part]), flat(pt[part])
        assert gj.keys() == gp.keys() == g8.keys() == p8.keys() == pj.keys() == pp.keys()
        rel = lambda a, b: np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        for k in gj:
            assert rel(p8[k], g8[k]) <= F64_REL_L2, (part, k, rel(p8[k], g8[k]))
            jax_off, resize_off = rel(gj[k], g8[k]), rel(r8[k], g8[k])
            assert jax_off <= 1e-2, (part, k, jax_off)
            assert rel(gp[k], gj[k]) <= GRAD_REL_L2 or rel(gp[k], g8[k]) <= max(
                jax_off, resize_off) + GRAD_REL_L2, (part, k, rel(gp[k], gj[k]),
                                                     rel(gp[k], g8[k]), jax_off, resize_off)
            g = np.abs(gj[k])
            loose = ((g < 1e-6 * g.max()) | (np.sqrt(nu_j[k] / bias) < 1000 * ADAM_EPS)
                     | (np.sign(gp[k]) != np.sign(gj[k])))
            n_loose[0] += loose.sum()
            n_loose[1] += loose.size
            err = np.where(loose, 0.0, np.abs(pp[k] - pj[k])).max()
            assert err <= PARAM_ATOL, (part, k, err)
    assert n_loose[0] <= 0.01 * n_loose[1], n_loose


def test_one_step_matches_jax(jax_init):
    run = run_both(jax_init, 1)
    (jm, jt), (pm, pt, g64) = run["jax"][0], run["port"][0]
    check_step(jm, jt, pm, pt, *step_grads(run, 0), g64)


def test_two_steps_match_jax(jax_init):
    """Two steps, the port's second from JAX's state after the first (as
    tests/test_torch_gan_trainer.py does: the first step's excepted
    entries part by up to 2 lr and would move the second's forward): Adam's
    second moments and bias corrections, the BN stats moved twice."""
    run = run_both(jax_init, 2)
    for step in (0, 1):
        (jm, jt), (pm, pt, g64) = run["jax"][step], run["port"][step]
        check_step(jm, jt, pm, pt, *step_grads(run, step), g64)


def test_epoch_lr_and_adam_reset():
    """epoch_lr: x0.98 an epoch, floored at lr / 10 (the JAX trainer's
    values); fit resets Adam (moments and count) at every epoch after the
    first and steps at that epoch's lr; the global step counts on."""
    jcfg, tcfg = damsm_configs()
    jt = JDAMSMTrainer(jcfg, VOCAB, use_inception=False)
    pt = DAMSMTrainer(tcfg, VOCAB, use_inception=False, device="cpu")
    for e in (0, 1, 2, 50, 113, 114, 500):
        assert pt.epoch_lr(e) == jt.epoch_lr(e), e
    assert pt.epoch_lr(500) < 2e-5 < pt.epoch_lr(113) and pt.epoch_lr(1) == 2e-4 * 0.98

    class Loader:
        def epoch(self, e):
            yield host_batch(e)

    ps = pt.init_state(torch.Generator().manual_seed(0))
    opts = []
    pt.fit(ps, Loader(), epochs=3, log_every=0,
           snapshot_fn=lambda s, e: opts.append((e, s.opt, s.step)), snapshot_interval=1)
    assert [e for e, _, _ in opts] == [0, 1, 2] and [s for *_, s in opts] == [1, 2, 3]
    assert len({id(o) for _, o, _ in opts}) == 3
    for e, opt, _ in opts:
        steps = {float(st["step"]) for st in opt.state.values()}
        assert steps == {1.0} and opt.param_groups[0]["lr"] == pt.epoch_lr(e)


@pytest.mark.parametrize("where", ["below", "above"])
def test_text_gradient_clip(where):
    """The text gradients are scaled by min(1, clip / max(|g|, 1e-12)), the
    CNN's are not: with the clip at twice the norm nothing changes; at half
    the norm the text moments halve exactly (torch's clip_grad_norm_ would
    give clip / (|g| + 1e-6))."""
    b = host_batch(3)
    _, tcfg = damsm_configs(clip=1e9)
    free = DAMSMTrainer(tcfg, VOCAB, use_inception=False, device="cpu")
    fs = free.init_state(torch.Generator().manual_seed(0))
    norm = float(free.train_step(fs, free.device_batch(b), 2e-4)["rnn_grad_norm"])
    clip = 2 * norm if where == "below" else norm / 2
    _, tcfg = damsm_configs(clip=clip)
    t = DAMSMTrainer(tcfg, VOCAB, use_inception=False, device="cpu")
    s = t.init_state(torch.Generator().manual_seed(0))
    m = t.train_step(s, t.device_batch(b), 2e-4)
    assert float(m["rnn_grad_norm"]) == norm
    want = 1.0 if where == "below" else clip / norm
    for (n, p), (_, q) in zip(t.trainable(s.text, s.cnn), free.trainable(fs.text, fs.cnn)):
        got, ref = s.opt.state[p]["exp_avg"], fs.opt.state[q]["exp_avg"]
        scale = want if n.startswith("text.") else 1.0
        torch.testing.assert_close(got, ref * scale, rtol=1e-6, atol=0, msg=n)


def test_dropout_keep_rate_and_scale():
    """Inverted dropout at 0.5: kept entries times 2, the rest 0, a keep
    rate within 5 sigma of 1/2; a seeded generator draws the same mask
    again; the trainer's step seeds it by (seed, global step); eval mode
    never draws and train mode at p = 0 is eval's output bit for bit."""
    x = torch.randn(64, 18, 300) + 3.0
    y = dropout(x, 0.5, torch.Generator().manual_seed(1))
    kept = y != 0
    n = x.numel()
    assert abs(kept.sum().item() - n / 2) < 5 * (n / 4) ** 0.5
    assert torch.equal(y[kept], x[kept] * 2.0)
    assert torch.equal(y, dropout(x, 0.5, torch.Generator().manual_seed(1)))
    _, tcfg = damsm_configs()
    t = DAMSMTrainer(tcfg, VOCAB, use_inception=False, seed=7, device="cpu")
    g1, g2 = t.dropout_generator(5), t.dropout_generator(5)
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))
    assert not torch.equal(torch.rand(8, generator=t.dropout_generator(6)),
                           torch.rand(8, generator=t.dropout_generator(5)))
    s = t.init_state(torch.Generator().manual_seed(0))
    b = t.device_batch(host_batch(0))
    s.text.eval()
    ref = s.text(b["captions"], b["cap_lens"])
    s.text.train()
    s.text.drop_prob = 0.0
    for a, r in zip(s.text(b["captions"], b["cap_lens"]), ref):
        assert torch.equal(a, r)
    s.text.drop_prob = 0.5
    s.text.eval()
    for a, r in zip(s.text(b["captions"], b["cap_lens"], generator=g1), ref):
        assert torch.equal(a, r)


def test_bf16_step_close_to_f32():
    """compute_dtype bfloat16 (the CNN in bf16 from float32 masters) against
    float32 from one init: every state tensor stays float32 and each metric
    above 1e-3 is within 10 %, JAX's own gate (tests/test_damsm_trainer.py)."""
    _, tcfg = damsm_configs()
    b = host_batch(0)
    metrics = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = DAMSMTrainer(tcfg, VOCAB, use_inception=False, compute_dtype=dtype, device="cpu")
        s = t.init_state(torch.Generator().manual_seed(0))
        metrics[dtype] = {k: float(v) for k, v in t.train_step(s, t.device_batch(b), 2e-3).items()}
        leaves = [*s.text.state_dict().values(), *s.cnn.state_dict().values()]
        leaves += [v for st in s.opt.state.values() for v in st.values() if v.dim()]
        assert all(x.dtype in (torch.float32, torch.int64) for x in leaves)
    for k, a in metrics[torch.float32].items():
        v = metrics[torch.bfloat16][k]
        assert np.isfinite(v), k
        if abs(a) > 1e-3:
            assert abs(a - v) / abs(a) < 0.1, (k, a, v)


def test_fit_nan_abort():
    """A diverged run raises at its log point instead of training on."""
    _, tcfg = damsm_configs(lr=1e9)
    t = DAMSMTrainer(tcfg, VOCAB, use_inception=False, device="cpu")
    s = t.init_state(torch.Generator().manual_seed(0))

    class Loader:
        def epoch(self, e):
            for _ in range(4):
                yield host_batch(0)

    with pytest.raises(FloatingPointError, match="NaN/Inf"):
        t.fit(s, Loader(), epochs=3, log_every=1)


def test_steps_run_with_tf32_off(monkeypatch):
    """train_step, eval_step and embed_step run with cuDNN's and cuBLAS's
    TF32 switches off whatever the caller set (PyTorch turns cuDNN's on by
    default), and leave them as they were."""
    import tgsr_tpu_torch.engine.damsm_trainer as mod

    seen = []
    sent = mod.sent_loss

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return sent(*args, **kw)

    monkeypatch.setattr(mod, "sent_loss", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _, tcfg = damsm_configs()
    t = DAMSMTrainer(tcfg, VOCAB, use_inception=False, device="cpu")
    s = t.init_state(torch.Generator().manual_seed(0))
    b = t.device_batch(host_batch(0))
    t.train_step(s, b, 2e-4)
    t.eval_step(s, b)
    with monkeypatch.context() as m:
        m.setattr(mod.TextEncoder, "forward", lambda self, *a, **kw: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            or (torch.zeros(B, T, EMB), torch.zeros(B, EMB)))
        t.embed_step(s, b)
    assert seen == [(False, False)] * 3
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
