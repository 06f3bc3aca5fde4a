"""Data parallelism and sharded storage of the port's trainers on the CPU:
two gloo ranks as subprocesses (tests/torch_dp_worker.py) on a free port,
`mesh = parallel.mesh.make_mesh(2, 1, "cpu")`, each rank on its two rows of
a global batch of 4, at the tiny x8 training geometry of
tests/torch_train_parity.py (BASE_SIZE 8, GF_DIM 16, DF_DIM 16) with the
DAMSM terms of a SimpleCNNEncoder ('damsm' 0.5), and the DAMSM trainer at
tests/test_torch_damsm_trainer.py's (SimpleCNN, nef 32, T 6, B 4).

- One GAN step and one DAMSM step (dropout on: each rank takes its rows of
  the global mask) equal the port's single-process step on the global batch
  within float reassociation (`adam_failures`, GATES). The GAN step
  computed in float64 (`compute_dtype=torch.float64`; float32 masters,
  stats and text encoder) shows that the two are the same maths: metrics
  within rtol 1e-7, Adam's moments per tensor within relative L2 1e-5, BN
  stats within 1e-6, the float32 rounding of the stored state. In float32
  the step is sensitive (about 30 train-mode BNs, whose backward divides by
  the batch's deviation): on this batch the float32 DP step parts from the
  single-process one beyond tests/test_torch_gan_trainer.py's 1e-4 in some
  moment tensors, as the port's single-process step parts from JAX's
  there, so float32 is held at metrics rtol 1e-4, moments 1e-3, BN stats
  rtol 1e-4. Parameters and EMA within 1e-6 in both, but where
  Adam's first step turns on a gradient's last bits: |g| below 1e-6 max
  |g| of its tensor, sqrt(v_hat) below 1000 eps, or a gradient of the other
  sign in the two (tests/test_torch_damsm_trainer.py's rule: the first step
  moves every entry by +-lr, the sign of its gradient), at most 1 % of the
  entries. The DAMSM step at the float32 gates;
- the float64 GAN step equals JAX's float64 step (x64) under
  `make_mesh(2, 1)` (the conftest gives JAX 8 host devices) from the same
  weights at the gates of tests/test_torch_gan_trainer.py (float32 steps
  part from each other there by these gates' size on this batch, as the
  port's single-process step does from JAX's), and the DAMSM step (dropout
  0 on both sides) JAX's float32 step under the same mesh at
  tests/test_torch_damsm_trainer.py's;
- `--fsdp` (parameters, moments and EMA stored sharded) equals DP bit for
  bit, and shards what `fsdp_spec` shards;
- a checkpoint written by the 2 sharded ranks restores bit for bit into one
  process, and one written by one process into the 2 sharded ranks;
- BatchNorm's global moments and the cross-rank mismatched pair matter: a
  step with either computed from a rank's own rows fails the
  single-process comparison.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.engine.damsm_trainer import DAMSMTrainer as JDAMSMTrainer
from tgsr_tpu.engine.gan_trainer import GANTrainer as JGANTrainer
from tgsr_tpu.engine.gan_trainer import GANTrainState as JGANTrainState
from tgsr_tpu.models.image_encoder import SimpleCNNEncoder as JSimpleCNNEncoder
from tgsr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tgsr_tpu_torch.checkpoints import dcp_io
from tgsr_tpu_torch.checkpoints.from_jax import (cnn_encoder_state_dict, cnn_encoder_variables,
                                                 seeded_cnn_encoder_state_dict,
                                                 seeded_text_state_dict, text_state_dict,
                                                 text_variables)
from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
from tgsr_tpu_torch.models.image_encoder import make_image_encoder
from tgsr_tpu_torch.parallel.mesh import fsdp_spec
from tgsr_tpu_torch.parallel.multihost import fetch_to_host, free_port
from tests import test_torch_damsm_trainer as damsm_t
from tests.test_torch_gan_trainer import gate_failures, jax_trees
from tests.torch_train_parity import EMB, VOCAB, batch, jax_batch, port_trees, train_configs

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LENS, CLASS_IDS = 4, (6, 3, 1, 5), np.array([1, 2, 1, 3], np.int32)  # 0 and 2 share a class
DAMSM_LR = 2e-4
ADAM_EPS = 1e-8
GATES = {  # metric rtol, first moment rel L2, second moment rel L2, params atol, stats rtol
    "float32": (1e-4, 1e-3, 1e-3, 1e-6, 1e-4),
    "float64": (1e-7, 1e-5, 1e-5, 1e-6, 1e-6),
}


def gan_port(cnn_sd, dtype=torch.float32):
    _, tcfg = train_configs()
    text = seeded_text_state_dict(tcfg, VOCAB, torch.Generator().manual_seed(3))
    enc = make_image_encoder(True, EMB)
    enc.load_state_dict(cnn_sd)
    return GANTrainer(tcfg, VOCAB, text, image_encoder=enc, loss_weights={"damsm": 0.5},
                      compute_dtype=dtype, device="cpu"), text


def jax_gan_step64(text_sd, cnn_sd, init_state, b):
    """JAX's float64 GANTrainer step (x64 on) under make_mesh(2, 1) from the
    port's initial weights; (metrics, jax_trees)."""
    jcfg, _ = train_configs()
    with jax.enable_x64(True):
        v = jax.tree.map(jnp.asarray, cnn_encoder_variables(cnn_sd))
        enc = JSimpleCNNEncoder(nef=EMB)
        jt = JGANTrainer(jcfg, VOCAB, text_variables(text_sd), mesh=jax_make_mesh(2, 1),
                         image_encoder_apply=lambda img: enc.apply(v, img),
                         reuse_g_forward=True, loss_weights={"damsm": 0.5},
                         compute_dtype=jnp.float64)
        tr = jax.tree.map(jnp.asarray, port_trees(init_state))
        js = JGANTrainState(step=jnp.zeros((), jnp.int32), g_params=tr["g_params"],
                            g_stats=tr["g_stats"], g_ema=jax.tree.map(jnp.copy, tr["g_params"]),
                            d_params=tr["d_params"], d_stats=tr["d_stats"],
                            g_opt=jt.g_tx.init(tr["g_params"]),
                            d_opt=jt.d_tx.init(tr["d_params"]))
        js, jm, _ = jt.train_step(js, jax_batch(b), jax.random.PRNGKey(2))
        return {k: float(x) for k, x in jm.items()}, jax_trees(js)


def damsm_port(drop):
    _, tcfg = damsm_t.damsm_configs()
    t = DAMSMTrainer(tcfg, VOCAB, use_inception=False, device="cpu")
    s = t.init_state(torch.Generator().manual_seed(0))
    return t, s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    cnn_sd = seeded_cnn_encoder_state_dict(True, EMB, torch.Generator().manual_seed(5))
    pt, text_sd = gan_port(cnn_sd)
    b = {**batch(B, LENS, seed=7), "class_ids": CLASS_IDS}
    init = pt.init_state(torch.Generator().manual_seed(0))
    init_sd = fetch_to_host(init.state_dict())
    single = pt.init_state(torch.Generator().manual_seed(0))
    gm = {k: float(v) for k, v in pt.train_step(single, b).items()}
    pt64, _ = gan_port(cnn_sd, torch.float64)
    single64 = pt64.init_state(torch.Generator().manual_seed(0))
    gm64 = {k: float(v) for k, v in pt64.train_step(single64, b).items()}
    ckpt_1rank = str(root / "ckpt_1rank")
    dcp_io.save_train_state(ckpt_1rank, 1, single.state_dict())

    # DAMSM: JAX's init carried into the port (test_torch_damsm_trainer's)
    jcfg, tcfg = damsm_t.damsm_configs()
    jdt = JDAMSMTrainer(jcfg, VOCAB, use_inception=False, mesh=jax_make_mesh(2, 1))
    jdt.text_encoder = jdt.text_encoder.clone(drop_prob=0.0)
    js0 = jax.tree.map(np.asarray, jax.jit(
        lambda k: jdt.init_state(k, damsm_t.SIZE, B, init_on_cpu=False))(jax.random.PRNGKey(0)))
    damsm_text_sd = text_state_dict({"params": js0.text_params})
    damsm_cnn_sd = cnn_encoder_state_dict({"params": js0.cnn_params,
                                           "batch_stats": js0.cnn_stats})
    hb = {**damsm_t.host_batch(4), "class_ids": CLASS_IDS}
    damsm_single = {}
    for tag, drop in (("damsm_dp", 0.5), ("damsm_dp_nodrop", 0.0)):
        t, s = damsm_port(drop)
        t.load_state(s, damsm_text_sd, damsm_cnn_sd)
        s.text.drop_prob = drop
        db = t.device_batch(hb)
        if drop == 0.0:
            g64 = {"port": damsm_t.float64_grads(t, s, db),
                   "resize f32": damsm_t.float64_grads(t, s, db, resize_in_float32=True)}
        m = t.train_step(s, db, DAMSM_LR)
        damsm_single[tag] = ({k: float(v) for k, v in m.items()}, t, s)

    spec = {"gan_cfg": train_configs()[1], "vocab": VOCAB, "nef": EMB, "text_sd": text_sd,
            "cnn_sd": cnn_sd, "gan_init": init_sd, "gan_batch": b, "damsm_cfg": tcfg,
            "damsm_text_sd": damsm_text_sd, "damsm_cnn_sd": damsm_cnn_sd, "damsm_batch": hb,
            "damsm_lr": DAMSM_LR, "ckpt_1rank": ckpt_1rank,
            "ckpt_2ranks": str(root / "ckpt_2ranks"), "out": str(root / "out.pt")}
    spec_path = str(root / "spec.pt")
    torch.save(spec, spec_path)
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    workers = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_dp_worker.py"),
                                 spec_path, str(r), "2", str(port)], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
               for r in range(2)]
    # JAX's mesh steps compile while the ranks run
    jax_gan = jax_gan_step64(text_sd, cnn_sd, init, b)
    js = jax.tree.map(jnp.asarray, js0)
    g64["jax"] = damsm_t.jax_float64_grads(jdt, js, hb)
    js, jm = jdt.train_step(js, jdt._device_batch(hb, None), DAMSM_LR, jax.random.PRNGKey(0))
    jax_damsm = ({k: float(v) for k, v in jm.items()}, damsm_t.jax_state_trees(js))
    for w in workers:
        log = w.communicate(timeout=300)[0].decode()
        assert w.returncode == 0, log[-3000:]
    out = torch.load(spec["out"], weights_only=False)
    return dict(out=out, gan_single=(gm, fetch_to_host(single.state_dict())), pt=pt,
                gan_single64=(gm64, fetch_to_host(single64.state_dict())),
                damsm_single=damsm_single, jax_gan=jax_gan, jax_damsm=jax_damsm, g64=g64,
                spec=spec)


def _param_keys(opt_key):
    """'g_opt.netgh.a.exp_avg' -> ['a', 'g_ema.netgh.a']; D's have no EMA."""
    name = opt_key.split(".", 1)[1].rsplit(".", 1)[0]
    return ["a" if name == "netgh.a" else name] + (
        [f"g_ema.{name}"] if opt_key.startswith("g_opt.") else [])


def adam_failures(ref, got, moments, dtype="float32", step=1):
    """Where `got` leaves the module docstring's gates around `ref` (flat
    name -> tensor readouts after `step` Adam steps); `moments`: (first
    moment key, second moment key, the keys of the tensors its Adam
    update moves). The other floating tensors are held at the stats gate,
    the integer ones exactly."""
    _, mu_rel, nu_rel, atol, stats_rtol = GATES[dtype]
    assert ref.keys() == got.keys()
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double()) / max(
        float(torch.linalg.vector_norm(b.double())), 1e-30))
    fails, n_loose, moved = [], [0, 0], set()
    for mk, nk, keys in moments:
        mu, nu = ref[mk], ref[nk]
        if rel(got[mk], mu) > mu_rel:
            fails.append(("grad", mk, rel(got[mk], mu)))
        if rel(got[nk], nu) > nu_rel:
            fails.append(("nu", nk, rel(got[nk], nu)))
        loose = ((mu.abs() < 1e-6 * mu.abs().max())
                 | (torch.sqrt(nu / (1 - 0.999 ** step)) < 1000 * ADAM_EPS)
                 | (torch.sign(got[mk]) != torch.sign(mu)))
        n_loose[0] += int(loose.sum())
        n_loose[1] += loose.numel()
        for k in keys:
            moved.add(k)
            err = torch.where(loose, 0.0, (got[k] - ref[k]).abs())
            if not bool((err <= atol).all()):
                fails.append(("param", k, float(err.max())))
    if n_loose[0] > 0.01 * n_loose[1]:
        fails.append(("cap", n_loose))
    for k in ref:
        if k in moved or any(k in m[:2] for m in moments):
            continue
        if not ref[k].is_floating_point():
            if not torch.equal(ref[k], got[k]):
                fails.append(("exact", k))
        elif not torch.allclose(got[k], ref[k], rtol=stats_rtol, atol=1e-6):
            fails.append(("stats", k))
    return fails


def gan_failures(ref, got, dtype):
    moments = [(k, k[:-len("exp_avg")] + "exp_avg_sq", _param_keys(k))
               for k in ref if k.endswith(".exp_avg")]
    return adam_failures(ref, got, moments, dtype)


def metric_failures(ref, got, rtol):
    assert ref.keys() == got.keys()
    return [k for k in ref if not abs(got[k] - ref[k]) <= rtol * abs(ref[k])]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gan_step_equals_the_single_process_step(runs, dtype):
    gm, gsd = runs["gan_single64" if dtype == "float64" else "gan_single"]
    m, sd = runs["out"]["gan_dp64" if dtype == "float64" else "gan_dp"]
    assert metric_failures(gm, m, GATES[dtype][0]) == []
    assert gan_failures(gsd, sd, dtype) == []


def damsm_flat(t, s):
    """The DAMSM state as `torch_dp_worker.damsm_readout` reads it."""
    named = dict(t.trainable(s.text, s.cnn))
    return {"text": fetch_to_host(s.text.state_dict()), "cnn": fetch_to_host(s.cnn.state_dict()),
            "mu": {n: s.opt.state[p]["exp_avg"] for n, p in named.items()},
            "nu": {n: s.opt.state[p]["exp_avg_sq"] for n, p in named.items()}}


def flatten_damsm(r):
    out = {f"{part}.{k}": v for part in ("text", "cnn") for k, v in r[part].items()}
    out.update({f"mu.{k}": v for k, v in r["mu"].items()})
    out.update({f"nu.{k}": v for k, v in r["nu"].items()})
    return out


def test_damsm_step_equals_the_single_process_step(runs):
    """Dropout on: each rank draws the global batch's mask and takes its
    rows; the words and sentence losses run over every pair of the global
    batch, with the class mask across ranks."""
    for tag in ("damsm_dp", "damsm_dp_nodrop"):
        sm, t, s = runs["damsm_single"][tag]
        m, got = runs["out"][tag]
        assert metric_failures(sm, m, GATES["float32"][0]) == [], tag
        ref, got = flatten_damsm(damsm_flat(t, s)), flatten_damsm(got)
        moments = [(f"mu.{n}", f"nu.{n}", [n]) for n in dict(t.trainable(s.text, s.cnn))]
        assert adam_failures(ref, got, moments) == [], tag


def test_fsdp_equals_dp_bit_for_bit(runs):
    m_dp, dp = runs["out"]["gan_dp"]
    m_fs, fs = runs["out"]["gan_fsdp"]
    assert m_dp == m_fs
    assert [k for k in dp if not torch.equal(dp[k], fs[k])] == []
    sharded = runs["out"]["fsdp_sharded"]
    want = {k for k, v in dp.items() if not k.endswith(".step") and "num_batches" not in k
            and fsdp_spec(v.shape, 2) and (k.split(".")[0] in ("netg", "netgh", "dnets", "a")
                                          or k.split(".")[0] in ("g_ema", "g_opt", "d_opt"))
            and not k.endswith(("running_mean", "running_var"))}
    assert set(sharded) == want and want
    for k, shape in sharded.items():
        assert int(np.prod(shape)) * 2 == dp[k].numel(), k


def test_gan_step_matches_jax_under_a_2x1_mesh(runs):
    pm, sd = runs["out"]["gan_dp64"]
    pt = runs["pt"]
    state = pt.init_state(torch.Generator().manual_seed(1))
    state.load_state_dict(sd)
    jm, jt = runs["jax_gan"]
    fails = gate_failures(jm, jt, pm, port_trees(state))
    assert not fails, fails[:10]


def test_damsm_step_matches_jax_under_a_2x1_mesh(runs):
    m, got = runs["out"]["damsm_dp_nodrop"]
    _, t, s = runs["damsm_single"]["damsm_dp_nodrop"]
    t.load_state(s, got["text"], got["cnn"])
    for n, p in t.trainable(s.text, s.cnn):
        s.opt.state[p]["exp_avg"] = got["mu"][n]
    pt_trees = damsm_t.port_state_trees(t, s)
    jm, jt = runs["jax_damsm"]
    g_jax = jax.tree.map(lambda x: np.asarray(x) / 0.5, jt["mu"])
    g_port = jax.tree.map(lambda x: np.asarray(x) / 0.5, pt_trees["mu"])
    damsm_t.check_step(jm, jt, m, pt_trees, g_jax, g_port, runs["g64"])


def test_checkpoints_restore_across_world_sizes(runs):
    """2 sharded ranks -> 1 process, and 1 process -> 2 sharded ranks, bit
    for bit."""
    _, fs = runs["out"]["gan_fsdp"]
    pt = runs["pt"]
    one = pt.init_state(torch.Generator().manual_seed(1))
    sd, step = dcp_io.restore_train_state(runs["spec"]["ckpt_2ranks"], one.state_dict())
    one.load_state_dict(sd)
    got = fetch_to_host(one.state_dict())
    assert step == 1 and [k for k in fs if not torch.equal(fs[k], got[k])] == []
    _, single = runs["gan_single"]
    back = runs["out"]["restored_1to2"]
    assert [k for k in single if not torch.equal(single[k], back[k])] == []


@pytest.mark.parametrize("ablation", ["gan_local_bn", "gan_local_pairs"])
def test_dropping_the_coupling_fails(runs, ablation):
    """BatchNorm's moments from a rank's own rows, or the mismatched pairs
    within a rank's rows: the step parts from the single-process one beyond
    the gates that DP meets."""
    gm, gsd = runs["gan_single"]
    m, sd = runs["out"][ablation]
    assert metric_failures(gm, m, GATES["float32"][0]) and gan_failures(gsd, sd, "float32")
    assert metric_failures(gm, m, 1e-3)  # and by far
