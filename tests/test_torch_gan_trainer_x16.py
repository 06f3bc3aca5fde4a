"""The port's GANTrainer on the x16 family against tgsr_tpu's on the CPU.

The tiny x16 tree of tests/test_gan_trainer_x16.py (BRANCH_NUM 5, BASE_SIZE
4, B = 2: a pyramid of 8 to 64 px, four DNets). The steps held against JAX's
run at the x8 test's widths (PARITY_WIDTH: GF_DIM 16, DF_DIM 16), one JAX
init carried into the port's state, at the gates of the x8 test
(tests/test_torch_gan_trainer.py `check_step`: metrics rtol 1e-4, each
gradient within relative L2 1e-4, BN stats, parameters and EMA within 1e-6
off the entries at Adam's epsilon). At JAX's own widths (8) the first step
leaves those gates where JAX's float32 step leaves them against its own
float64 step: tests/test_torch_gan_trainer_x16_width8.py. The tests that
hold the port against itself run at width 8. The tied modules (h_net2 called three
times, img_net1 four, residual48 and upscale8x twice) move their BN stats
once a call, in JAX's order, and sum their gradients over the calls. Each
JAX trainer compiles its step once for the module (about 13 s). Also: the
512 px DNet, the DAMSM terms on the x16 fake, `eval_metrics` at 512 px, the
ties after a step, `plan_batch` on the CPU, and the training CLI with
`--remat all`.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.gan_trainer import GANTrainer as JGANTrainer
from tgsr_tpu_torch.checkpoints.from_jax import text_state_dict
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
from tests.test_torch_gan_trainer import check_step, encoder_pair, jax_trees
from tests.torch_train_parity import (VOCAB, batch, flat, jax_batch, load_jax_opt,
                                      load_jax_state, port_trees, text_vars, train_configs)

torch.set_num_threads(1)
B, LENS = 2, (6, 0)
SIZES = (8, 16, 32, 64)
PARITY_WIDTH = 16


def configs():
    """The tiny x16 tree at PARITY_WIDTH: (JAX's Config, the port's)."""
    return train_configs(branch_num=5, width=PARITY_WIDTH)


def x16_batch(seed=0, lens=LENS):
    return batch(B, lens, seed=seed, sizes=SIZES)


@pytest.fixture(scope="module")
def jax_init():
    """(JAX x16 trainer, its initial state as numpy), the init jitted once."""
    jcfg, _ = configs()
    jt = JGANTrainer(jcfg, VOCAB, text_vars(), reuse_g_forward=True)
    js = jax.jit(lambda k: jt.init_state(k, B, init_on_cpu=False))(jax.random.PRNGKey(0))
    return jt, jax.tree.map(np.asarray, js)


def port_trainer(js, **kw):
    _, tcfg = configs()
    pt = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), device="cpu", **kw)
    ps = pt.init_state(torch.Generator().manual_seed(0))
    load_jax_state(pt, ps, js)
    return pt, ps


def run_both(jax_init, steps, d_lr=None, restart=False):
    """As the x8 test's `run_both`, for the x16 tree."""
    jt0, js = jax_init
    jcfg, _ = configs()
    jt = jt0 if d_lr is None else JGANTrainer(jcfg, VOCAB, text_vars(), reuse_g_forward=True,
                                               d_lr=d_lr)
    js = js.replace(g_opt=jt.g_tx.init(js.g_params), d_opt=jt.d_tx.init(js.d_params))
    pt, ps = port_trainer(js, d_lr=d_lr)
    out = {"jax": [], "port": []}
    rng = jax.random.PRNGKey(2)
    for i in range(steps):
        b = x16_batch(seed=i)
        if restart and i:
            load_jax_state(pt, ps, jax.tree.map(np.asarray, js))
            load_jax_opt(ps, out["jax"][-1][1])
        js, jm, rng = jt.train_step(js, jax_batch(b), rng)
        out["jax"].append(({k: float(v) for k, v in jm.items()}, jax_trees(js)))
        pm = pt.train_step(ps, b)
        out["port"].append(({k: float(v) for k, v in pm.items()}, port_trees(ps)))
    return out


def test_one_x16_step_matches_jax(jax_init):
    """The family switch: four scales of G's pyramid and four DNets, the
    tied trees, one step at the x8 gates (g_loss3 is the 64 px scale's)."""
    (jm, jt), (pm, pt) = (x[0] for x in run_both(jax_init, 1).values())
    assert {"g_loss0", "g_loss3"} <= set(pm)
    assert sorted(pt["d_params"]) == ["d16", "d32", "d64", "d8"]
    assert "h_net3" not in pt["g_params"]["netg"] and "img_net2" not in pt["g_params"]["netg"]
    check_step(jm, jt, pm, pt)


def test_two_x16_steps_match_jax(jax_init):
    """Two steps, D frozen on both sides, the port's second from JAX's state
    after the first (why: tests/test_torch_gan_trainer.py
    test_two_steps_match_jax): Adam's second step on the tied tensors, the
    EMA twice, the shared BNs' stats on moved weights."""
    run = run_both(jax_init, 2, d_lr=0.0, restart=True)
    for step in (0, 1):
        (jm, jt), (pm, pt) = run["jax"][step], run["port"][step]
        check_step(jm, jt, pm, pt, g_moved=step == 1)


def test_ties_hold_after_a_step(jax_init):
    """After a step the aliases are still the shared modules, Adam holds one
    state per tensor (the deduplicated parameters), and the shared stage's
    BNs were moved once a call: three times in h_net2, once in h_net1."""
    _, js = jax_init
    pt, ps = port_trainer(js)
    pt.train_step(ps, x16_batch())
    g = ps.netg
    assert g.h_net3 is g.h_net2 and g.h_net4 is g.h_net2
    assert all(getattr(g, f"img_net{k}") is g.img_net1 for k in (2, 3, 4))
    params = [p for _, p in ps.g_named_parameters()]
    assert len({id(p) for p in params}) == len(params) == len(ps.g_opt.state)
    assert set(map(id, ps.g_opt.state)) == set(map(id, params))
    assert sum(p.numel() for p in params) == sum(
        v.size for v in flat(port_trees(ps)["g_params"]).values())
    sd = g.state_dict()
    assert int(sd["h_net2.upsample.2.num_batches_tracked"]) == 3
    assert int(sd["h_net4.upsample.2.num_batches_tracked"]) == 3
    assert int(sd["h_net1.upsample.2.num_batches_tracked"]) == 1
    assert int(ps.netgh.state_dict()["residual48.1.num_batches_tracked"]) == 2


def test_x16_damsm_terms_simple_cnn_match_jax(jax_init):
    """SimpleCNN's DAMSM terms on the x16 fake (the finest, resized by the
    encoder), as JAX's step passes `fine_g` to `generator_loss`, at the
    one-step gates."""
    _, js = jax_init
    jcfg, _ = configs()
    jm, v, pm = encoder_pair("simple")
    jt = JGANTrainer(jcfg, VOCAB, text_vars(), image_encoder_apply=lambda img: jm.apply(v, img),
                     reuse_g_forward=True)
    js = js.replace(g_opt=jt.g_tx.init(js.g_params), d_opt=jt.d_tx.init(js.d_params))
    pt, ps = port_trainer(js, image_encoder=pm)
    b = {**x16_batch(lens=(6, 3)), "class_ids": np.array([0, 1], np.int32)}
    js, jmet, _ = jt.train_step(js, jax_batch(b), jax.random.PRNGKey(2))
    pmet = {k: float(x) for k, x in pt.train_step(ps, b).items()}
    assert {"w_loss", "s_loss"} <= set(pmet)
    check_step({k: float(x) for k, x in jmet.items()}, jax_trees(js), pmet, port_trees(ps))


def test_bf16_x16_step_close_to_f32():
    """compute_dtype bfloat16 against float32 from one init: float32 state
    (the tied tensors cast once a call), each first-step metric above 1e-3
    within 15 %, JAX's gate."""
    _, tcfg = train_configs(branch_num=5)
    tv = text_state_dict(text_vars())
    b = x16_batch()
    metrics = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = GANTrainer(tcfg, VOCAB, tv, compute_dtype=dtype, device="cpu")
        s = t.init_state(torch.Generator().manual_seed(0))
        metrics[dtype] = {k: float(v) for k, v in t.train_step(s, b).items()}
        assert all(x.dtype in (torch.float32, torch.int64) for x in
                   [*s.netg.state_dict().values(), *s.netgh.state_dict().values(),
                    *s.dnets.state_dict().values(), *s.g_ema.values()])
    for k, a in metrics[torch.float32].items():
        v = metrics[torch.bfloat16][k]
        assert np.isfinite(v), k
        if abs(a) > 1e-3:
            assert abs(a - v) / abs(a) < 0.15, (k, a, v)


def test_eval_metrics_at_512_px_match_jax():
    """eval_metrics of the x16 EMA generator at the full pyramid (32 px LR,
    512 px top): PSNR-Y and SSIM-Y against JAX's eval on the same
    trees, read back from the port's state (BN running stats drawn away
    from 0 and 1, so that eval BN does real work)."""
    import dataclasses

    jcfg, tcfg = (dataclasses.replace(c, TREE=dataclasses.replace(c.TREE, BASE_SIZE=32))
                  for c in train_configs(branch_num=5))
    t = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), device="cpu")
    s = t.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in [*s.netg.modules(), *s.netgh.modules()]:
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    b = batch(2, (6, 2), seed=5, sizes=(64, 128, 256, 512))
    assert tuple(t.super_resolve(s, b).shape) == (2, 512, 512, 3)
    trees = port_trees(s)
    jt = JGANTrainer(jcfg, VOCAB, text_vars())
    jm = jt.eval_metrics(trees["g_ema"], trees["g_stats"], jax_batch(b))
    pm = t.eval_metrics(s, b)
    for k in ("psnr_y", "ssim_y"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_dnet_at_512_px_matches_jax():
    """The 512 px DNet (three down pairs past 64 px) against JAX's, train
    mode: features, both logits, the running stats, and the gradients of
    the logits' sum with respect to the image and every parameter."""
    from tgsr_tpu.models.discriminator import DNet as JDNet
    from tgsr_tpu_torch.checkpoints.from_jax import dnet_state_dict, dnet_variables
    from tgsr_tpu_torch.models.discriminator import DNet

    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 1, (2, 512, 512, 3)).astype(np.float32)
    sent = rng.normal(0, 1, (2, 32)).astype(np.float32)
    jd = JDNet(ndf=8, nef=32, img_size=512)
    v = jax.tree.map(np.asarray, jax.jit(jd.init)(jax.random.PRNGKey(4), img, sent))
    assert len([k for k in v["params"] if k.startswith("extra_")]) == 6

    def jloss(params, img):
        (c, u), upd = jd.apply({"params": params, "batch_stats": v["batch_stats"]}, img, sent,
                               train=True, mutable=["batch_stats"])
        return (c * 1.5 + u).sum(), (c, u, upd["batch_stats"])

    (_, (jc, ju, jstats)), (jgp, jgi) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(v["params"], img)
    d = DNet(ndf=8, nef=32, img_size=512)
    d.load_state_dict(dnet_state_dict(v, 512), strict=True)
    d.train()
    x = torch.from_numpy(img).permute(0, 3, 1, 2).requires_grad_()
    c, u = d(x, torch.from_numpy(sent))
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(ju), rtol=1e-4, atol=1e-5)
    grads = torch.autograd.grad((c * 1.5 + u).sum(), [x, *d.parameters()])
    gi = grads[0].permute(0, 2, 3, 1).numpy()
    assert np.linalg.norm(gi - jgi) <= 1e-4 * np.linalg.norm(jgi)
    got = dnet_variables({**dict(zip([n for n, _ in d.named_parameters()], grads[1:])),
                          **{n: b for n, b in d.named_buffers()}})
    ref = flat(jax.tree.map(np.asarray, jgp))
    for k, g in flat(got["params"]).items():
        assert np.linalg.norm(g - ref[k]) <= 1e-4 * max(np.linalg.norm(ref[k]), 1e-30), k
    stats = flat(dnet_variables(d.state_dict())["batch_stats"])
    for k, r in flat(jax.tree.map(np.asarray, jstats)).items():
        np.testing.assert_allclose(stats[k], r, rtol=1e-5, atol=1e-6, err_msg=k)


def test_plan_batch_refuses_the_cpu_and_remat_is_checked():
    """plan_batch measures a step's peak on the card and raises ValueError on
    the CPU, with a budget or without (JAX answers there when given one: a
    deliberate difference); an unknown remat policy raises JAX's ValueError."""
    _, tcfg = train_configs(branch_num=5)
    tv = text_state_dict(text_vars())
    t = GANTrainer(tcfg, VOCAB, tv, remat="all", device="cpu")
    for budget in (None, 2 ** 30):
        with pytest.raises(ValueError, match="CUDA device"):
            t.plan_batch(budget_bytes=budget)
    with pytest.raises(ValueError, match=r"remat must be False/True/'all'/'low'/'high', "
                                         r"got 'bogus'"):
        GANTrainer(tcfg, VOCAB, tv, remat="bogus", device="cpu")


def test_plan_batch_from_its_probes(monkeypatch):
    """plan_batch's answer from its probes (the card's capped runs stood in
    for: a probe completes where its need is under the cap, and each probe
    is capped at the budget): lo, then a bisection over the multiples of
    `quantum` up to `hi`, giving the largest that fits (also where the need
    grows faster than linearly, and where only lo fits); 0 where lo does not
    fit, and nothing more is measured. A batch whose first run completes is
    run again, and fits only where that run completes too (the last case:
    32's second run runs out of memory)."""
    _, tcfg = train_configs(branch_num=5)
    t = GANTrainer(tcfg, VOCAB, text_state_dict(text_vars()), device="cpu")
    t.device = torch.device("cuda")  # what plan_batch asks for; no probe runs here
    wide = [8, 24, 32, 40, 72, 136, 264, 520]
    # need(b, k): the bytes the k-th run at batch b needs, None out of memory
    cases = [(lambda b, k: 1000 + 30 * b, 2000, 1024, 32, wide),  # fits up to 33
             (lambda b, k: 1000 + 30 * b, 2000, 20, 16, [8, 16]),  # hi 20
             (lambda b, k: 1000 + 30 * b, 1100, 1024, 0, [8]),  # lo needs 1240
             (lambda b, k: 1000 + 30 * b if b == 8 else None, 2000, 1024, 8,
              [8, 16, 24, 40, 72, 136, 264, 520]),  # out of memory above lo
             (lambda b, k: None, 2000, 1024, 0, [8]),
             (lambda b, k: 500 + 10 * b + b * b, 2000, 1024, 32, wide),  # fits up to 34
             (lambda b, k: None if (b, k) == (32, 1) else 1000 + 30 * b, 2000, 1024, 24, wide)]
    for need, budget, hi, want, measured in cases:
        runs = []

        def capped(b, cap, need=need, budget=budget, runs=runs):
            assert cap == budget, f"probe capped at {cap}, not the budget"
            n = need(b, runs.count(b))
            runs.append(b)
            return n if n is not None and n <= cap else None

        monkeypatch.setattr(t, "step_peak_bytes", capped)
        assert t.plan_batch(budget_bytes=budget, hi=hi) == want, (budget, hi)
        assert t.batch_plan["batch"] == want and t.batch_plan["budget_bytes"] == budget
        assert sorted(t.batch_plan["probes"]) == measured
        assert all((v is not None) == (b <= want) for b, v in t.batch_plan["probes"].items())
        first_fits = lambda b: need(b, 0) is not None and need(b, 0) <= budget
        assert all(runs.count(b) == (2 if first_fits(b) else 1) for b in measured)


YAML16 = """# a tiny x16 face training config
CONFIG_NAME: 'tiny_face_S16_train'
METHOD: 'S16'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 5
    BASE_SIZE: 4
GAN:
    GF_DIM: 16
    DF_DIM: 16
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 1
"""


def test_cli_trains_x16_with_remat_and_its_snapshot_serves(jax_init, tmp_path):
    """`cli.train_gan --cfg <S16 tree> --remat all --device cpu`: 2 steps on
    the example face set (4 train images, batch 2), x16 snapshot pairs that
    JAX's load_variables reads into the tree a JAX x16 init has (one
    h_net2, one img_net1), and that the port's SRPipeline serves equal to
    the trainer's super_resolve (the EMA generator, eval BN)."""
    from tgsr_tpu.checkpoints.io import load_variables as jax_load_variables
    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.cli import train_gan
    from tgsr_tpu_torch.cli.test import load_config
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tests.torch_cli_data import make_train_face_set

    data = str(tmp_path / "data")
    n_words = make_train_face_set(data, n=5, seed=3)
    cfg_path = tmp_path / "train16.yml"
    cfg_path.write_text(YAML16)
    cfg = load_config(str(cfg_path), data)
    te = str(tmp_path / "text_encoder.pth")
    torch.save(seeded_text_state_dict(cfg, n_words, torch.Generator().manual_seed(1)), te)
    out = str(tmp_path / "out")
    s = train_gan.main(["--cfg", str(cfg_path), "--data_dir", data, "--text_encoder", te,
                        "--device", "cpu", "--out_dir", out, "--epochs", "1", "--remat", "all",
                        "--log_every", "1"])
    assert s["steps"] == 2 and s["trainer"].remat == "all"
    model = os.path.join(out, "Model")
    assert sorted(os.listdir(model)) == ["netGH_it1.msgpack", "netGH_it2.msgpack",
                                         "netG_it1.msgpack", "netG_it2.msgpack"]
    with open(os.path.join(out, "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2 and all(np.isfinite(r[k]) for r in rows for k in r)
    assert all("g_loss3" in r for r in rows)
    g = jax_load_variables(os.path.join(model, "netG_it2.msgpack"))
    gh = jax_load_variables(os.path.join(model, "netGH_it2.msgpack"))
    _, js = jax_init  # a JAX init of the same generators
    jnetg, jnetgh = ({"params": js.g_params[k], "batch_stats": js.g_stats[k]}
                     for k in ("netg", "netgh"))
    for got, ref in ((g, jnetg), (gh, jnetgh)):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    pipe = SRPipeline.from_reference_checkpoints(cfg, n_words,
                                                 os.path.join(model, "netG_it2.msgpack"),
                                                 text_encoder_path=te, device="cpu")
    rng = np.random.default_rng(0)
    lr = rng.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
    cap = rng.integers(1, n_words, (2, 6)).astype(np.int32)
    lens = np.array([6, 2], np.int32)
    cap[1, 2:] = 0
    served = pipe(lr, cap, lens)["sr"]
    eager = s["trainer"].super_resolve(s["state"], {"lr": lr, "captions": cap,
                                                    "cap_lens": lens})
    assert served.shape == eager.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(served.numpy(), eager.numpy(), rtol=0, atol=1e-5)
