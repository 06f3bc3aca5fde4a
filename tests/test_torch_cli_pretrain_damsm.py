"""The port's DAMSM pretraining CLI (tgsr_tpu_torch.cli.pretrain_damsm) on the
CPU: `--simple-cnn` at BASE_SIZE 32 (nef 32, T 6, batch 2) on
tests/torch_cli_data.py's face set in the training layout (4 train images,
one test image: 2 steps an epoch), two epochs with a snapshot each.

- the run writes JAX's snapshot pair per epoch, the attention grid and the
  metric rows;
- a resume from text_encoder0 writes epoch 1's snapshots byte for byte as
  the uninterrupted run does;
- the port's snapshots load in JAX (`load_variables`) into the trees JAX's
  encoders take, and compute there what they compute in the port (rtol =
  atol = 1e-4, the encoders' gate in tests/test_torch_image_encoder.py);
  snapshots JAX writes resume in the port;
- a family mismatch, --mesh and --tensorboard exit with their reason.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints.io import load_variables as jax_load_variables
from tgsr_tpu.checkpoints.io import save_variables as jax_save_variables
from tgsr_tpu.models.image_encoder import SimpleCNNEncoder as JSimpleCNNEncoder
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu_torch.checkpoints.from_jax import cnn_encoder_state_dict, text_state_dict
from tgsr_tpu_torch.cli import pretrain_damsm
from tgsr_tpu_torch.data.codec import decode_png
from tgsr_tpu_torch.models.image_encoder import SimpleCNNEncoder
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tests.torch_cli_data import make_train_face_set

torch.set_num_threads(1)
YAML = """# a tiny face DAMSM config (cfg/DAMSM/face.yml's schema at narrow width)
CONFIG_NAME: 'tiny_face_damsm'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 1
    BASE_SIZE: 32
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 2
    SNAPSHOT_INTERVAL: 1
    ENCODER_LR: 0.002
"""
EMB, T = 32, 6


def _run(env, out, *extra):
    return pretrain_damsm.main(env["base"] + ["--out_dir", out, *extra])


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_damsm")
    data = str(root / "data")
    n_words = make_train_face_set(data, n=5, seed=4)
    cfg = root / "damsm.yml"
    cfg.write_text(YAML)
    base = ["--cfg", str(cfg), "--data_dir", data, "--simple-cnn", "--device", "cpu"]
    env = dict(root=root, data=data, base=base, n_words=n_words)
    env["full"] = _run(env, str(root / "full"), "--csv")
    return env


def test_run_writes_snapshots_grids_and_metrics(env):
    s = env["full"]
    model = os.path.join(s["out_dir"], "Model")
    assert sorted(os.listdir(model)) == ["image_encoder0.msgpack", "image_encoder1.msgpack",
                                         "text_encoder0.msgpack", "text_encoder1.msgpack"]
    for e in (0, 1):
        with open(os.path.join(s["out_dir"], "Image", f"attention_maps{e}.png"), "rb") as f:
            grid = decode_png(f.read())
        assert grid.ndim == 3 and grid.shape[2] == 3 and grid.std() > 0
    with open(os.path.join(s["out_dir"], "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "loss" in r]
    assert [(r["epoch"], r["step"]) for r in train] == [(0, 1), (1, 3)]
    assert set(train[0]) == {"step", "time", "epoch", "lr", "w_loss", "s_loss", "loss",
                             "rnn_grad_norm"}
    assert [r["epoch"] for r in rows if "val" in r] == [0, 1]
    assert train[1]["lr"] == pytest.approx(0.002 * 0.98)
    assert all(np.isfinite(r[k]) for r in rows for k in r if k != "time")
    assert os.path.exists(os.path.join(s["out_dir"], "Log", "metrics.csv"))


def test_resume_equals_the_uninterrupted_run(env, capsys):
    """One epoch, then --resume_from its text_encoder0: epoch 1's snapshot
    pair is the uninterrupted run's, byte for byte (the Adam reset at the
    epoch, the (seed, epoch) loader, the dropout seeded by the global step)."""
    first = _run(env, str(env["root"] / "first"), "--epochs", "1")
    snap = os.path.join(first["out_dir"], "Model", "text_encoder0.msgpack")
    resumed = _run(env, str(env["root"] / "resumed"), "--resume_from", snap)
    assert "continuing at epoch 1" in capsys.readouterr().out
    assert resumed["start_epoch"] == 1
    for name in ("text_encoder1.msgpack", "image_encoder1.msgpack"):
        with open(os.path.join(resumed["out_dir"], "Model", name), "rb") as f:
            got = f.read()
        with open(os.path.join(env["full"]["out_dir"], "Model", name), "rb") as f:
            assert got == f.read(), name


def test_snapshots_load_in_jax(env):
    """text_encoder1 / image_encoder1 read by JAX's load_variables have the
    trees JAX's TextEncoder and SimpleCNNEncoder init, and compute there
    what the port's encoders compute on the same input."""
    model = os.path.join(env["full"]["out_dir"], "Model")
    tv = jax_load_variables(os.path.join(model, "text_encoder1.msgpack"))
    cv = jax_load_variables(os.path.join(model, "image_encoder1.msgpack"))
    jt = JTextEncoder(vocab_size=env["n_words"], nhidden=EMB)
    jc = JSimpleCNNEncoder(nef=EMB)
    caps = np.array([[1, 2, 3, 0, 0, 0], [2, 1, 0, 0, 0, 0]], np.int32)
    lens = np.array([3, 2], np.int32)
    img = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    for got, mod, x in ((tv, jt, (caps, lens)), (cv, jc, (img,))):
        init = mod.init(jax.random.PRNGKey(0), *map(jnp.asarray, x))
        assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, init))
    pt = TextEncoder(env["n_words"], 300, EMB).eval()
    pt.load_state_dict(text_state_dict(tv), strict=True)
    pc = SimpleCNNEncoder(EMB).eval()
    pc.load_state_dict(cnn_encoder_state_dict(cv), strict=True)
    with torch.no_grad():
        port = (*pt(torch.from_numpy(caps).long(), torch.from_numpy(lens).long()),
                *pc(torch.from_numpy(img)))
    ref = (*jt.apply(tv, jnp.asarray(caps), jnp.asarray(lens)), *jc.apply(cv, jnp.asarray(img)))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_jax_snapshots_resume_in_the_port(env, tmp_path, capsys):
    """A text_encoder3 / image_encoder3 pair that JAX's save_variables wrote
    (JAX inits) resumes in the port at epoch 4 with exactly those weights."""
    model = tmp_path / "Model"
    model.mkdir()
    caps = jnp.ones((1, T), jnp.int32)
    tv = JTextEncoder(vocab_size=env["n_words"], nhidden=EMB).init(
        jax.random.PRNGKey(1), caps, jnp.ones((1,), jnp.int32))
    cv = JSimpleCNNEncoder(nef=EMB).init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    jax_save_variables(str(model / "text_encoder3.msgpack"), tv)
    jax_save_variables(str(model / "image_encoder3.msgpack"), cv)
    s = _run(env, str(tmp_path / "out"), "--resume_from", str(model / "text_encoder3.msgpack"),
             "--epochs", "4")
    assert s["start_epoch"] == 4 and s["history"] == []
    state = s["state"]
    for module, tree, conv in ((state.text, tv, text_state_dict),
                               (state.cnn, cv, cnn_encoder_state_dict)):
        want = conv(jax.tree.map(np.asarray, tree))
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_refusals(env):
    snap = os.path.join(env["full"]["out_dir"], "Model", "text_encoder0.msgpack")
    base = [a for a in env["base"] if a != "--simple-cnn"]
    with pytest.raises(SystemExit, match="pass --simple-cnn"):
        pretrain_damsm.main(base + ["--out_dir", str(env["root"] / "never"),
                                    "--resume_from", snap])
    with pytest.raises(SystemExit, match="must point at a text_encoder"):
        _run(env, str(env["root"] / "never"), "--resume_from", snap + ".bak")
    for flag in (["--mesh", "8x1"], ["--tensorboard"]):
        with pytest.raises(SystemExit, match="A 10"):
            _run(env, str(env["root"] / "never"), *flag)
    assert not os.path.exists(env["root"] / "never")
