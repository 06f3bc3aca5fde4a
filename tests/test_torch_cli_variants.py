"""The entry points of tgsr_tpu_torch on configs with the EVAL switches, on
the CPU: no new flag, the YAML says it.

- `cli.test` with 'lr-lrblur' and weight maps (x8 at BASE_SIZE 32, the
  maps' size; GF_DIM 8) against JAX's `cli.test` on the same `.pth` files
  (JAX's convert_netgh_weight reads the maps): float32 SR within one
  uint8 level;
- `cli.calibrate` on a stage-1 config (its scales carry the shared up1's
  one key each), then `cli.test --scales` with them;
- `cli.export_aot` of the weight-map config, its program bit for bit the
  live pipeline;
- `cli.serve`: the weight-map pipeline answers a fixed-size POST, and a
  native POST whose size the maps do not fit with 400;
- `cli.train_gan` with 'lr-lrblur' and weight maps (the tiny x16 tree, maps
  at its pyramid's sizes): snapshots with a1..a4 and no `a`, served equal to
  the run's EMA generator; STAGE1 refused with the reason.
"""

import contextlib
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from tgsr_tpu import native
from tgsr_tpu.cli import test as jcli
from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, seeded_text_state_dict
from tgsr_tpu_torch.cli import calibrate, export_aot, serve, train_gan
from tgsr_tpu_torch.cli import test as tcli
from tgsr_tpu_torch.cli.test import load_config
from tgsr_tpu_torch.data.codec import encode_png, load_image_rgb
from tgsr_tpu_torch.engine import aot
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests.torch_cli_data import fresh_data, make_face_set, make_train_face_set

torch.set_num_threads(1)
EVAL_YAML = """# a narrow x8 face eval config with the EVAL switches
CONFIG_NAME: 'narrow_face_S8_variant'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: {base}
TRAIN:
    FLAG: False
    NET_G: 'absent/netG_epoch_7.pth'
GAN:
    GF_DIM: 8
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
EVAL:
{eval}"""
MAP = "    INPUT_NETGH: 'lr-lrblur'\n    WEIGHTMAP: True\n"
STAGE1 = "    STAGE1: True\n    INPUT_NETGH: 'lrblur'\n"


def _env(root, name, base, ev):
    """A face example set, the YAML and seeded .pth files (netG, netGH and
    the text encoder) of one variant under root/name."""
    d = os.path.join(root, name)
    data = os.path.join(d, "data")
    n_words = make_face_set(data, n=2, seed=0, n_attr=(1, 1))
    cfg_path = os.path.join(d, "cfg.yml")
    with open(cfg_path, "w") as f:
        f.write(EVAL_YAML.format(base=base, eval=ev))
    cfg = load_config(cfg_path, data)
    tcli.build_example_dataset(cfg)  # the vocabulary pickle, testset.pickle
    text_sd, netg_sd, netgh_sd, _ = init_seeded(cfg, n_words, torch.Generator().manual_seed(4))
    ckpt = os.path.join(d, "ckpt")
    os.makedirs(ckpt)
    for f, sd in (("netG_epoch_7.pth", netg_sd), ("netGH_epoch_7.pth", netgh_sd),
                  ("text_encoder.pth", text_sd)):
        torch.save(sd, os.path.join(ckpt, f))
    return dict(root=d, data=data, cfg=cfg_path, ckpt=ckpt, n_words=n_words,
                te=os.path.join(ckpt, "text_encoder.pth"),
                vocab=os.path.join(data, "testset.pickle"),
                common=["--cfg", cfg_path, "--ckpt_dir", ckpt, "--text_encoder",
                        os.path.join(ckpt, "text_encoder.pth")])


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_variants"))
    return {"map": _env(root, "map", 32, MAP), "stage1": _env(root, "stage1", 16, STAGE1)}


def _images(out):
    return sorted(f for f in os.listdir(out) if f.endswith("_SR.png"))


def test_cli_test_weight_map_matches_jax(envs):
    env = envs["map"]
    outs = {}
    for pkg in ("jax", "torch"):
        out = os.path.join(env["root"], f"out_{pkg}")
        argv = env["common"] + ["--no-bf16", "--data_dir", fresh_data(env, pkg), "--batch", "2",
                                "--out_dir", out]
        if pkg == "jax":
            with contextlib.redirect_stdout(io.StringIO()), pytest.MonkeyPatch.context() as m:
                m.setattr(native, "available", lambda: False)
                jcli.main(argv)
            outs[pkg] = os.path.join(out, "testset")
        else:
            outs[pkg] = tcli.main(argv + ["--device", "cpu"])["out_dir"]
    names = _images(outs["jax"])
    assert names and _images(outs["torch"]) == names
    for name in names:
        want = np.asarray(Image.open(os.path.join(outs["jax"], name)).convert("RGB"))
        got = load_image_rgb(os.path.join(outs["torch"], name))
        assert got.shape == want.shape == (256, 256, 3)
        assert np.abs(got.astype(int) - want).max() <= 1, name


def test_cli_calibrate_then_scales_stage1(envs):
    env = envs["stage1"]
    scales = os.path.join(env["root"], "scales.json")
    calibrate.main(env["common"] + ["--data_dir", fresh_data(env, "cal"), "--out", scales,
                                    "--batch", "2", "--batches", "1", "--device", "cpu"])
    with open(scales) as f:
        netg = json.load(f)["netg"]
    assert {"up1_conv", "up1_up/conv", "h_net2/conv1", "h_net3/conv2",
            "h_net1/residual_1/conv2"} <= set(netg)
    assert not any(k.startswith("h_net2/residual") for k in netg)
    summary = tcli.main(env["common"] + ["--scales", scales, "--data_dir",
                                         fresh_data(env, "int8"), "--batch", "2", "--out_dir",
                                         os.path.join(env["root"], "out_int8"), "--device",
                                         "cpu"])
    names = _images(summary["out_dir"])
    assert names and load_image_rgb(os.path.join(summary["out_dir"], names[0])).shape == (
        128, 128, 3)


def test_cli_export_aot_weight_map(envs, tmp_path):
    env = envs["map"]
    netg = os.path.join(env["ckpt"], "netG_epoch_7.pth")
    export_aot.main(["--cfg", env["cfg"], "--netg", netg, "--text_encoder", env["te"],
                     "--vocab_pickle", env["vocab"], "--f32", "--out", str(tmp_path / "aot"),
                     "--device", "cpu"])
    cfg = load_config(env["cfg"], env["data"])
    live = SRPipeline.from_reference_checkpoints(cfg, env["n_words"], netg,
                                                 text_encoder_path=env["te"], device="cpu")
    art = aot.AOTPipeline(str(tmp_path / "aot"), device="cpu")
    rng = np.random.default_rng(5)
    lr = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    cap = rng.integers(1, env["n_words"], (2, 6))
    lens = np.array([6, 2])
    cap[1, 2:] = 0
    np.testing.assert_array_equal(art.sr_uint8(lr, cap, lens), live.sr_uint8(lr, cap, lens))


def _post(port, body, native_mode):
    url = f"http://127.0.0.1:{port}/sr" + ("?mode=native" if native_mode else "")
    req = urllib.request.Request(url, data=body, headers={"X-Caption": "smiling woman"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_weight_map_native_answers_400(envs):
    env = envs["map"]
    pipe, vocab, _ = serve.boot(["--cfg", env["cfg"], "--netg",
                                 os.path.join(env["ckpt"], "netG_epoch_7.pth"), "--vocab_pickle",
                                 env["vocab"], "--text_encoder", env["te"], "--f32",
                                 "--device", "cpu"])
    assert pipe.cfg.EVAL.WEIGHTMAP and pipe.a is None
    httpd = serve.make_server(pipe, vocab, port=0)
    httpd.batcher.warmup()
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        img = np.random.default_rng(6).integers(0, 256, (32, 32, 3)).astype(np.uint8)
        status, body = _post(port, encode_png(img), native_mode=False)
        assert status == 200 and _png_shape(body) == (256, 256, 3)
        status, body = _post(port, encode_png(img), native_mode=True)
        assert status == 400 and b"weight map" in body
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()


def _png_shape(body):
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB")).shape


TRAIN_YAML16 = """# a tiny x16 face training config with the blur input and weight maps
CONFIG_NAME: 'tiny_face_S16_map_train'
METHOD: 'S16'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 5
    BASE_SIZE: 4
GAN:
    GF_DIM: 8
    DF_DIM: 8
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 2
EVAL:
{eval}"""


def test_cli_train_gan_weight_map(tmp_path):
    from tgsr_tpu_torch.checkpoints.msgpack_io import load_variables

    data = str(tmp_path / "data")
    n_words = make_train_face_set(data, n=5, seed=3)
    cfg_path = tmp_path / "train16.yml"
    cfg_path.write_text(TRAIN_YAML16.format(eval=MAP))
    cfg = load_config(str(cfg_path), data)
    te = str(tmp_path / "text_encoder.pth")
    torch.save(seeded_text_state_dict(cfg, n_words, torch.Generator().manual_seed(1)), te)
    out = str(tmp_path / "out")
    s = train_gan.main(["--cfg", str(cfg_path), "--data_dir", data, "--text_encoder", te,
                        "--device", "cpu", "--out_dir", out, "--epochs", "1"])
    assert s["steps"] == 2 and s["state"].a is None
    gh = load_variables(os.path.join(out, "Model", "netGH_it2.msgpack"))["params"]
    assert {"a1", "a2", "a3", "a4"} <= set(gh) and "a" not in gh
    assert [gh[f"a{i}"].shape for i in range(1, 5)] == [(8, 8), (16, 16), (32, 32), (64, 64)]
    pipe = SRPipeline.from_reference_checkpoints(
        cfg, n_words, os.path.join(out, "Model", "netG_it2.msgpack"), text_encoder_path=te,
        device="cpu")
    rng = np.random.default_rng(7)
    b = {"lr": torch.from_numpy(rng.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)),
         "captions": torch.from_numpy(rng.integers(1, n_words, (2, 6))),
         "cap_lens": torch.tensor([6, 6])}
    served = pipe(b["lr"].numpy(), b["captions"].numpy(), b["cap_lens"].numpy())["sr"]
    np.testing.assert_allclose(served.numpy(),
                               s["trainer"].super_resolve(s["state"], b).numpy(),
                               rtol=0, atol=1e-5)
    cfg_path.write_text(TRAIN_YAML16.format(eval="    STAGE1: True\n"))
    with pytest.raises(NotImplementedError, match="STAGE1"):
        train_gan.main(["--cfg", str(cfg_path), "--data_dir", data, "--text_encoder", te,
                        "--device", "cpu", "--out_dir", str(tmp_path / "out1")])
