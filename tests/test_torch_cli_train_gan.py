"""The port's GAN training CLI (tgsr_tpu_torch.cli.train_gan) on the CPU:
one tiny epoch on tests/torch_cli_data.py's face set (4 train images, one
test image; BASE_SIZE 8, GF_DIM 16, DF_DIM 16, batch 2, a snapshot every
step), the JAX CLI's metric rows, snapshots that JAX's `load_variables`
reads into the tree JAX's generators take (and that then compute what the
port's generators compute, within the float32 pipeline gate of
tests/test_torch_pipeline.py: rtol 1e-3, atol 2e-4), `--init_netg` from a
snapshot, and the refused flags.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints.io import load_variables as jax_load_variables
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import text_state_dict
from tgsr_tpu_torch.checkpoints.reference import load_generator_pair
from tgsr_tpu_torch.cli import train_gan
from tgsr_tpu_torch.cli.test import load_config
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests.torch_cli_data import make_train_face_set
from tests.torch_parity import configs, jax_trees

torch.set_num_threads(1)
YAML = """# a tiny x8 face training config
CONFIG_NAME: 'tiny_face_train'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: 8
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
METRIC_KEYS = {"step", "time", "d_loss", "g_loss", "g_loss0", "g_loss1", "g_loss2", "kl",
               "pixel", "adv"}
PYR = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_gan")
    data = str(root / "data")
    n_words = make_train_face_set(data, n=5, seed=3)
    cfg = root / "train.yml"
    cfg.write_text(YAML)
    jcfg, _ = configs(base_size=8, gf_dim=16, condition_dim=10, embedding_dim=32, words_num=6)
    text = jax_trees(jcfg, vocab=n_words, seed=1)[0]
    te = str(root / "text_encoder.pth")
    torch.save(text_state_dict(text), te)
    base = ["--cfg", str(cfg), "--data_dir", data, "--text_encoder", te, "--device", "cpu",
            "--log_every", "1"]
    out = str(root / "out")
    summary = train_gan.main(base + ["--out_dir", out, "--epochs", "1", "--eval_every", "1",
                                     "--csv"])
    return dict(root=root, data=data, cfg=str(cfg), base=base, out=out, summary=summary,
                n_words=n_words, text=text, jcfg=jcfg)


def test_one_epoch_logs_and_snapshots(env):
    s = env["summary"]
    assert s["steps"] == 2  # 4 train images, batch 2
    model = os.path.join(env["out"], "Model")
    assert sorted(os.listdir(model)) == ["netGH_it1.msgpack", "netGH_it2.msgpack",
                                         "netG_it1.msgpack", "netG_it2.msgpack"]
    with open(os.path.join(env["out"], "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "d_loss" in r]
    val_rows = [r for r in rows if "val_psnr_y" in r]
    assert [set(r) for r in train_rows] == [METRIC_KEYS] * 2
    assert [r["step"] for r in val_rows] == [0, 1]
    assert all(np.isfinite(r[k]) for r in rows for k in r if k != "step")
    assert all(-1 <= r["val_ssim_y"] <= 1 for r in val_rows)
    with open(os.path.join(env["out"], "Log", "metrics.csv")) as f:
        header = f.readline().strip().split(",")
    assert set(header) == METRIC_KEYS | {"val_psnr_y", "val_ssim_y"}


def test_snapshot_is_jaxs_tree_and_serves_the_same(env):
    """netG_it2 / netGH_it2 load with tgsr_tpu's load_variables into the tree
    a JAX init of the same geometry has, and JAX's pipeline on them computes
    what the port's pipeline on the same files computes."""
    model = os.path.join(env["out"], "Model")
    g = jax_load_variables(os.path.join(model, "netG_it2.msgpack"))
    gh = jax_load_variables(os.path.join(model, "netGH_it2.msgpack"))
    _, jnetg, jnetgh = jax_trees(env["jcfg"], vocab=env["n_words"])
    for got, ref in ((g, jnetg), (gh, jnetgh)):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    # the snapshot holds the EMA weights and the stats the run ended with
    state = env["summary"]["state"]
    netg_sd, netgh_sd, a = load_generator_pair(
        load_config(env["cfg"], env["data"]), os.path.join(model, "netG_it2.msgpack"))
    ema_g, ema_gh, ema_a = state.g_state_dicts()
    for got, ref in ((netg_sd, ema_g), (netgh_sd, ema_gh)):
        for k, v in got.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, ref[k]), k
    assert a == pytest.approx(ema_a, abs=0)
    cfg = load_config(env["cfg"], env["data"])
    rng = np.random.default_rng(0)
    lr = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    cap = rng.integers(1, env["n_words"], (2, 6)).astype(np.int32)
    lens = np.array([6, 2], np.int32)
    cap[1, 2:] = 0
    port = SRPipeline(cfg, env["n_words"], text_state_dict(env["text"]), netg_sd, netgh_sd, a,
                      device="cpu")
    ref = JSRPipeline(env["jcfg"], env["n_words"], env["text"], g, gh)(lr, cap, lens)
    got = port(lr, cap, lens)
    for x, y in zip(got["pyramid"], ref["pyramid"]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **PYR)


def test_init_netg_from_a_snapshot(env, capsys):
    snap = os.path.join(env["out"], "Model", "netG_it2.msgpack")
    out = str(env["root"] / "out_init")
    s = train_gan.main(env["base"] + ["--out_dir", out, "--epochs", "1", "--init_netg", snap])
    assert f"warm-started G from {snap}" in capsys.readouterr().out
    assert s["steps"] == 2
    with pytest.raises(SystemExit, match="--init_netg not found"):
        train_gan.main(env["base"] + ["--out_dir", out, "--init_netg", snap + ".absent"])


@pytest.mark.parametrize("argv,item", [
    (["--resume"], "A 10"), (["--mesh", "8x1"], "A 10"), (["--fsdp"], "A 10"),
    (["--remat", "bogus"], "argument --remat: invalid choice: 'bogus'"),
    (["--resume", "--remat", "all"], "A 10"),
    (["--tensorboard"], "A 10"),
])
def test_unported_flags_exit_with_their_roadmap_item(env, argv, item, capsys):
    """The flags that need unported parts exit naming their ROADMAP item
    (--remat is ported: a policy outside JAX's choices exits with JAX's
    argparse message, and --remat beside --resume still exits for
    --resume)."""
    with pytest.raises(SystemExit) as exc:
        train_gan.main(env["base"] + ["--out_dir", str(env["root"] / "never")] + argv)
    assert item in str(exc.value) + capsys.readouterr().err
    assert not os.path.exists(env["root"] / "never")


@pytest.mark.parametrize("family", ["simple", "inception"])
def test_image_encoder_adds_the_damsm_terms(env, family, capsys):
    """--image_encoder: a SimpleCNN `.msgpack` snapshot (cli.pretrain_damsm's
    form) or a reference-named Inception image_encoder `.pth`, the family
    read from the tree; every metric row then carries JAX's w_loss and
    s_loss, finite. A missing file exits naming it."""
    from tgsr_tpu_torch.checkpoints.from_jax import (cnn_encoder_variables,
                                                     seeded_cnn_encoder_state_dict)
    from tgsr_tpu_torch.checkpoints.io import save_variables

    sd = seeded_cnn_encoder_state_dict(family == "simple", 32, torch.Generator().manual_seed(2))
    if family == "simple":
        path = str(env["root"] / "image_encoder0.msgpack")
        save_variables(path, cnn_encoder_variables(sd))
    else:
        path = str(env["root"] / "image_encoder7.pth")
        torch.save(sd, path)
    out = str(env["root"] / f"out_damsm_{family}")
    s = train_gan.main(env["base"] + ["--out_dir", out, "--epochs", "1", "--image_encoder", path])
    want = "SimpleCNNEncoder" if family == "simple" else "CNNEncoder"
    assert f"DAMSM terms from {want} {path}" in capsys.readouterr().out
    assert s["steps"] == 2
    with open(os.path.join(out, "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [set(r) for r in rows] == [METRIC_KEYS | {"w_loss", "s_loss"}] * 2
    assert all(np.isfinite(r[k]) for r in rows for k in r)
    with pytest.raises(SystemExit, match="--image_encoder not found"):
        train_gan.main(env["base"] + ["--out_dir", out, "--image_encoder", path + ".absent"])


def test_loss_weight_flag_is_checked(env):
    with pytest.raises(SystemExit):
        train_gan.main(env["base"] + ["--loss_weight", "damsm=1"])


def test_save_variables_writes_flaxs_bytes(tmp_path):
    """checkpoints/io.save_variables writes the bytes
    flax.serialization.msgpack_serialize writes (sorted keys, ndarray and
    numpy-scalar extensions, msgpack's smallest headers), and its reader
    gives the tree back."""
    from flax import serialization

    from tgsr_tpu_torch.checkpoints.io import load_variables, msgpack_serialize, save_variables

    jcfg, _ = configs(base_size=8, gf_dim=16, condition_dim=10, embedding_dim=32, words_num=6)
    text, netg, netgh = jax_trees(jcfg, vocab=12)
    odd = {"z": 1, "a": {"y": np.float32(3.0), "b": [1, -5, 300, 70000, -200, 2 ** 40]},
           "c": "x" * 40, "d": 1.5, "e": True, "f": None, "g": np.zeros((0,)),
           "h": np.arange(5, dtype=np.int64)}
    for tree in (text, netg, netgh, odd):
        assert msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    path = str(tmp_path / "sub" / "netG_it1.msgpack")
    save_variables(path, netg)
    back = load_variables(path)
    assert jax.tree.structure(back) == jax.tree.structure(netg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(netg)):
        np.testing.assert_array_equal(a, b)
