"""Train-state checkpoints, resume, `train_steps` and `clip_by_global_norm`
of the port's GAN trainer on the CPU (tgsr_tpu_torch.engine.gan_trainer,
checkpoints/dcp_io.py, cli/train_gan.py --resume), at the tiny x8 training
geometry of tests/torch_train_parity.py (BASE_SIZE 8, GF_DIM 16, DF_DIM 16,
B 4), float32.

- JAX's tests/test_train_resume.py contract: 4 uninterrupted steps, against
  2 steps, a save through dcp_io, a restore into a fresh trainer's state and
  2 more steps, end bit for bit on the same state (every tensor of
  `state_dict()`: parameters, BN stats, EMA, both Adams, the grad_accum
  buffers), with grad_accum 1 and 2;
- the async `TrainCheckpointer` writes the state as it was at `save()`
  (later steps change nothing in it), keeps the newest three steps, and
  `latest_step` reads only committed steps;
- `cli.train_gan` stopped at step k (SIGTERM, or the end of its epochs) and
  rerun with `--resume` writes the uninterrupted run's snapshot bytes;
- `clip_by_global_norm` against `optax.clip_by_global_norm` on the same
  gradients, above and below the bound (rtol 1e-6: float32 sums of squares
  in another order), and a step with `clip_norm` against one without where
  the bound is never reached (bit for bit);
- `train_steps` against K `train_step` calls, bit for bit.
"""

import os
import signal

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgsr_tpu_torch.checkpoints import dcp_io
from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
from tgsr_tpu_torch.cli import train_gan
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer, clip_by_global_norm
from tgsr_tpu_torch.parallel.multihost import fetch_to_host
from tests.test_torch_cli_train_gan import YAML
from tests.torch_cli_data import make_train_face_set
from tests.torch_train_parity import VOCAB, batch, train_configs

torch.set_num_threads(1)
B, LENS = 4, (6, 3, 0, 5)


def trainer(**kw):
    _, cfg = train_configs()
    text = seeded_text_state_dict(cfg, VOCAB, torch.Generator().manual_seed(3))
    return GANTrainer(cfg, VOCAB, text, device="cpu", **kw)


def fresh(t):
    return t.init_state(torch.Generator().manual_seed(0))


def same_state(a, b):
    """The keys of two states' tensors that differ in any bit."""
    fa, fb = fetch_to_host(a.state_dict()), fetch_to_host(b.state_dict())
    assert fa.keys() == fb.keys()
    return [k for k in fa if not torch.equal(fa[k], fb[k])]


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_equals_the_uninterrupted_run(tmp_path, accum):
    t = trainer(grad_accum=accum)
    whole = fresh(t)
    for i in range(4):
        t.train_step(whole, batch(B, LENS, seed=i))

    part = fresh(t)
    for i in range(2):
        t.train_step(part, batch(B, LENS, seed=i))
    dcp_io.save_train_state(str(tmp_path / "ckpt"), 2, part.state_dict())
    assert dcp_io.latest_step(str(tmp_path / "ckpt")) == 2

    t2 = trainer(grad_accum=accum)  # a new process's trainer and state
    resumed = fresh(t2)
    sd, step = dcp_io.restore_train_state(str(tmp_path / "ckpt"), resumed.state_dict())
    resumed.load_state_dict(sd)
    assert (step, resumed.step, resumed.mini_step) == (2, 2, 2 % accum)
    assert same_state(resumed, part) == []
    for i in range(2, 4):
        t2.train_step(resumed, batch(B, LENS, seed=i))
    assert resumed.step == whole.step == 4
    assert same_state(resumed, whole) == []


def test_async_checkpointer_saves_the_state_at_save_time(tmp_path):
    t = trainer()
    s = fresh(t)
    d = str(tmp_path / "ckpt")
    with dcp_io.TrainCheckpointer(d) as w:
        for i in range(4):
            t.train_step(s, batch(B, LENS, seed=i))
            if s.step == 2:
                at_save = fetch_to_host(s.state_dict())
            w.save(s.step, s.state_dict())  # the next step runs while it writes
            assert w.latest_step() == s.step  # saved, or being saved
        with pytest.raises(ValueError, match="already exists"):
            w.wait()
            w.save(4, s.state_dict())
    assert dcp_io.all_steps(d) == [2, 3, 4]  # max_to_keep 3
    os.makedirs(os.path.join(d, "7"))  # a step never committed does not count
    assert dcp_io.latest_step(d) == 4
    back = fresh(t)
    sd, _ = dcp_io.restore_train_state(d, back.state_dict(), step=2)
    back.load_state_dict(sd)
    got = fetch_to_host(back.state_dict())
    assert back.step == 2
    assert [k for k in at_save if not torch.equal(at_save[k], got[k])] == []
    with pytest.raises(FileNotFoundError):
        dcp_io.restore_train_state(str(tmp_path / "none"), back.state_dict())


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume_cli")
    data = str(root / "data")
    make_train_face_set(data, n=5, seed=3)
    cfg = root / "train.yml"
    cfg.write_text(YAML)
    base = ["--cfg", str(cfg), "--data_dir", data, "--device", "cpu", "--log_every", "1"]
    whole = str(root / "whole")
    summary = train_gan.main(base + ["--out_dir", whole, "--epochs", "2"])
    assert summary["steps"] == 4  # 4 train images, batch 2, two epochs
    return dict(root=root, base=base, whole=whole)


def snapshot_bytes(out, it):
    with open(os.path.join(out, "Model", f"netG_it{it}.msgpack"), "rb") as f:
        g = f.read()
    with open(os.path.join(out, "Model", f"netGH_it{it}.msgpack"), "rb") as f:
        return g, f.read()


def test_cli_resume_after_the_epochs_end(cli_env):
    """One epoch (a checkpoint at step 2), then --resume --epochs 2: the
    resumed run starts at step 2 and its step-4 snapshot pair is the
    uninterrupted run's, byte for byte."""
    out = str(cli_env["root"] / "two_runs")
    first = train_gan.main(cli_env["base"] + ["--out_dir", out, "--epochs", "1"])
    assert first["steps"] == 2 and dcp_io.latest_step(first["ckpt_dir"]) == 2
    second = train_gan.main(cli_env["base"] + ["--out_dir", out, "--epochs", "2", "--resume"])
    assert second["start_step"] == 2 and second["steps"] == 4
    assert snapshot_bytes(out, 4) == snapshot_bytes(cli_env["whole"], 4)


def test_cli_sigterm_then_resume(cli_env, monkeypatch, capsys):
    """SIGTERM during step 1 (the second): the run ends after that step, as
    the uninterrupted run's state at step 2, with its snapshot pair and a
    checkpoint; --resume then ends on the uninterrupted run's bytes."""
    out = str(cli_env["root"] / "stopped")
    real_step = GANTrainer.train_step

    def step_then_signal(self, state, b):
        metrics = real_step(self, state, b)
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    monkeypatch.setattr(GANTrainer, "train_step", step_then_signal)
    stopped = train_gan.main(cli_env["base"] + ["--out_dir", out, "--epochs", "2",
                                                "--csv"])
    monkeypatch.setattr(GANTrainer, "train_step", real_step)
    assert stopped["stopped"] and stopped["steps"] == 2
    assert "interrupted; saving final checkpoint" in capsys.readouterr().out
    assert snapshot_bytes(out, 2) == snapshot_bytes(cli_env["whole"], 2)
    assert dcp_io.latest_step(stopped["ckpt_dir"]) == 2
    resumed = train_gan.main(cli_env["base"] + ["--out_dir", out, "--epochs", "2", "--resume",
                                                "--csv"])
    assert (resumed["start_step"], resumed["steps"]) == (2, 4)
    assert snapshot_bytes(out, 4) == snapshot_bytes(cli_env["whole"], 4)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 5), (7,), (2, 2, 4), ())]
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads))
    for max_norm in (norm / 3, norm * 2):
        want = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                          optax.EmptyState())[0]
        got, n = clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
        np.testing.assert_allclose(float(n), float(optax.global_norm(
            [jnp.asarray(g) for g in grads])), rtol=1e-6)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_clip_norm_in_the_step():
    """A bound above every gradient's norm leaves the step as it is, bit for
    bit; a tight one changes it, and Adam then still moves each entry by
    about lr (its first step normalises the gradient), so the parameters
    stay close."""
    plain, loose, tight = trainer(), trainer(clip_norm=1e9), trainer(clip_norm=1e-3)
    states = [fresh(x) for x in (plain, loose, tight)]
    for x, s in zip((plain, loose, tight), states):
        x.train_step(s, batch(B, LENS, seed=0))
    assert same_state(states[0], states[1]) == []
    diff = same_state(states[0], states[2])
    assert any(k.startswith("g_opt.") for k in diff) and any(k.startswith("d_opt.") for k in diff)


def test_train_steps_equals_k_train_step_calls():
    t = trainer()
    a, b = fresh(t), fresh(t)
    batches = [batch(B, LENS, seed=i) for i in range(3)]
    per = [t.train_step(a, x) for x in batches]
    stacked = {"lr": np.stack([x["lr"] for x in batches]),
               "real_pyramid": [np.stack([x["real_pyramid"][j] for x in batches])
                                for j in range(3)],
               "captions": np.stack([x["captions"] for x in batches]),
               "cap_lens": np.stack([x["cap_lens"] for x in batches])}
    ms = t.train_steps(b, stacked)
    assert same_state(a, b) == []
    assert set(ms) == set(per[0])
    for k, v in ms.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([m[k] for m in per])), k
