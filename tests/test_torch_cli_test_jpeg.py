"""The CLIs on JPEG data sets (tests/torch_jpeg_data.py):

- the port's eval CLI (tgsr_tpu_torch/cli/test.py, `--device cpu`) against
  tgsr_tpu's cli.test on the flower example set (3 JPEGs of 70-140 px,
  testset.txt names, one-word captions, the train split's vocabulary;
  BASE_SIZE 16, GF_DIM 8, 128 px SR), `--no-bf16`: every `<key>_SR.png`
  within 1 level of JAX's (JAX pinned to its PIL path, as
  tests/test_torch_cli_test.py pins it), one attention grid per image; the
  coco config on the same set writes the same bytes (the configs differ in
  DATASET_NAME alone);
- the port's calibration CLI on the flower set: the scales within 1e-4 of
  JAX's, the gates of tests/test_torch_cli_calibrate.py;
- the port's GAN training and DAMSM pretraining CLIs, one tiny epoch each
  on a bird-layout JPEG set (bounding-box crops): finite metrics and their
  snapshots."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tgsr_tpu import native
from tgsr_tpu.cli import calibrate as jcal
from tgsr_tpu.cli import test as jcli
from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
from tgsr_tpu_torch.cli import calibrate as tcal
from tgsr_tpu_torch.cli import pretrain_damsm, train_gan
from tgsr_tpu_torch.cli import test as tcli
from tgsr_tpu_torch.cli.test import load_config
from tgsr_tpu_torch.data.codec import load_image_rgb
from tests.torch_jpeg_data import make_example_env, make_text_tree

torch.set_num_threads(1)


def _args(env, tag):
    d = os.path.join(env["root"], f"data_{tag}")
    shutil.copytree(env["data"], d)
    return ["--cfg", env["cfg"], "--ckpt_dir", env["ckpt"], "--text_encoder",
            env["text_encoder"], "--data_dir", d, "--batch", "2"]


def _jax(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as m:
        m.setattr(native, "available", lambda: False)
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def flower(tmp_path_factory):
    return make_example_env(str(tmp_path_factory.mktemp("flower")), dataset="flower", seed=3)


def _sr(out_dir):
    d = os.path.join(out_dir, "testset")
    return {f: load_image_rgb(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if f.endswith("_SR.png")}


def test_eval_cli_f32_within_one_level_of_jax(flower):
    env = flower
    t_out, j_out = os.path.join(env["root"], "out_torch"), os.path.join(env["root"], "out_jax")
    summary = tcli.main(_args(env, "torch") + ["--no-bf16", "--out_dir", t_out,
                                               "--device", "cpu"])
    _jax(jcli.main, _args(env, "jax") + ["--no-bf16", "--out_dir", j_out])
    got, j_dir = _sr(t_out), os.path.join(j_out, "testset")
    names = sorted(f for f in os.listdir(j_dir) if f.endswith("_SR.png"))
    assert len(names) == 3 and sorted(got) == names
    for name in names:
        want = np.asarray(Image.open(os.path.join(j_dir, name)).convert("RGB"))
        assert got[name].shape == want.shape == (128, 128, 3)
        assert np.abs(got[name].astype(int) - want).max() <= 1, name
    assert sorted(os.listdir(os.path.join(t_out, "testset", "att"))) == sorted(
        os.listdir(os.path.join(j_dir, "att")))
    assert summary["images"] == summary["grids"] == 3
    # the coco config: the same example set and weights, the same bytes
    coco = dict(env, cfg=os.path.join(env["root"], "coco.yml"))
    with open(env["cfg"]) as f, open(coco["cfg"], "w") as g:
        g.write(f.read().replace("'flower'", "'coco'"))
    c_out = os.path.join(env["root"], "out_coco")
    tcli.main(_args(coco, "coco") + ["--no-bf16", "--out_dir", c_out, "--device", "cpu"])
    for name, img in _sr(c_out).items():
        np.testing.assert_array_equal(img, got[name])


def test_calibrate_cli_on_jpegs_matches_jax(flower):
    env = flower
    out = {}
    for pkg in ("torch", "jax"):
        path = os.path.join(env["root"], f"scales_{pkg}.json")
        argv = _args(env, f"cal_{pkg}") + ["--out", path, "--batches", "1"]
        if pkg == "torch":
            tcal.main(argv + ["--device", "cpu"])
        else:
            _jax(jcal.main, argv)
        with open(path) as f:
            out[pkg] = json.load(f)
    j, t = out["jax"], out["torch"]
    assert t.keys() == j.keys()
    for g in ("netg", "netgh"):
        assert t[g].keys() == j[g].keys() and j[g]
        for k in j[g]:
            assert abs(t[g][k] - j[g][k]) <= 1e-4 * j[g][k], (g, k)
    assert t["_meta"]["gate_db"] >= 35 and abs(t["_meta"]["gate_db"]
                                               - j["_meta"]["gate_db"]) <= 3.0


TRAIN_YAML = """# a tiny x8 bird training config
CONFIG_NAME: 'tiny_bird_train'
DATASET_NAME: 'birds'
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
    CAPTIONS_PER_IMAGE: 2
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 1
"""
DAMSM_YAML = """# a tiny bird DAMSM config
CONFIG_NAME: 'tiny_bird_damsm'
DATASET_NAME: 'birds'
TREE:
    BRANCH_NUM: 1
    BASE_SIZE: 32
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 2
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 1
    ENCODER_LR: 0.002
"""


@pytest.fixture(scope="module")
def birds(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_jpeg")
    data = str(root / "birds")
    make_text_tree(data, "bird", seed=6, n_train=2, n_test=1)
    return root, data


def test_train_gan_on_bird_jpegs(birds):
    root, data = birds
    cfg = root / "train.yml"
    cfg.write_text(TRAIN_YAML)
    from tgsr_tpu_torch.data.datasets import TextSRDataset

    n_words = TextSRDataset(data, split="train", embeddings_num=2).n_words
    te = str(root / "text_encoder.pth")
    torch.save(seeded_text_state_dict(load_config(str(cfg)), n_words,
                                      torch.Generator().manual_seed(1)), te)
    out = str(root / "gan")
    summary = train_gan.main(["--cfg", str(cfg), "--data_dir", data, "--text_encoder", te,
                              "--device", "cpu", "--out_dir", out, "--epochs", "1"])
    assert summary["steps"] == 1
    assert sorted(os.listdir(os.path.join(out, "Model"))) == ["netGH_it1.msgpack",
                                                              "netG_it1.msgpack"]
    with open(os.path.join(out, "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(np.isfinite(r[k]) for r in rows for k in r if k != "step")


def test_pretrain_damsm_on_bird_jpegs(birds):
    root, data = birds
    cfg = root / "damsm.yml"
    cfg.write_text(DAMSM_YAML)
    s = pretrain_damsm.main(["--cfg", str(cfg), "--data_dir", data, "--simple-cnn", "--device",
                             "cpu", "--out_dir", str(root / "damsm")])
    assert sorted(os.listdir(os.path.join(s["out_dir"], "Model"))) == [
        "image_encoder0.msgpack", "text_encoder0.msgpack"]
    with open(os.path.join(s["out_dir"], "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(np.isfinite(r[k]) for r in rows for k in r
                        if isinstance(r[k], float))
