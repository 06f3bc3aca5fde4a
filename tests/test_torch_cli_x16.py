"""The port's CLIs serving the x16 family (a narrow S16 YAML: BRANCH_NUM 5,
BASE_SIZE 8 -> 128 px, GF_DIM 8; seeded .pth weights in the reference's
models16 layout, tests/torch_cli_data.py) against tgsr_tpu's CLIs on the
same files, on the CPU (`--device cpu`).

Gates, those of the x8 CLI tests: cli.test `--no-bf16` within 1 uint8 level
of JAX's SR images, the bfloat16 default >= 50 dB, `--int8` >= 40 dB (each
package calibrates on its own float32 twin), each image's attention grid of
JAX's shape; cli.calibrate's scales within 1e-4 relative of JAX's, with the
same keys (the tied stage and head under h_net2 / img_net1) and weights
fingerprint; cli.serve booted from the YAML, the .pth pair and a vocab
pickle answers 128 px POSTs within 1 level of JAX's direct pipeline on the
codec-resized LR (float32), and `--int8`, whose shipped face S8 scales do
not fit the x16 family, is refused as JAX refuses it, with the reason.
"""

import contextlib
import io
import json
import os
import pickle
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgsr_tpu import native
from tgsr_tpu.cli import calibrate as jcal
from tgsr_tpu.cli import test as jcli
from tgsr_tpu.config import config_from_file as jconfig_from_file
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.cli import calibrate as tcal
from tgsr_tpu_torch.cli import serve
from tgsr_tpu_torch.cli import test as tcli
from tgsr_tpu_torch.data.codec import encode_png, load_image_rgb, resize_pil_bicubic
from tests.torch_cli_data import common_args, fresh_data, make_env

torch.set_num_threads(1)
MODES = {"f32": ["--no-bf16"], "bf16": [], "int8": ["--int8"]}
OUT = 128


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(str(tmp_path_factory.mktemp("cli_x16")), n_attr=(1, 1), x16=True)


def _jax(main, argv):
    """JAX's CLI reading images through PIL, as the port does."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as m:
        m.setattr(native, "available", lambda: False)
        main(argv)
    return buf.getvalue()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_test_matches_jax(env, mode):
    outs = {}
    for pkg in ("jax", "torch"):
        argv = common_args(env) + MODES[mode] + [
            "--data_dir", fresh_data(env, f"{pkg}_{mode}"), "--batch", "2",
            "--out_dir", os.path.join(env["root"], f"out_{pkg}_{mode}")]
        if pkg == "jax":
            _jax(jcli.main, argv)
            outs[pkg] = os.path.join(env["root"], f"out_{pkg}_{mode}", "testset")
        else:
            summary = tcli.main(argv + ["--device", "cpu"])
            assert summary["images"] == 3 and summary["int8"] == (mode == "int8")
            outs[pkg] = summary["out_dir"]
    names = sorted(f for f in os.listdir(outs["jax"]) if f.endswith("_SR.png"))
    assert len(names) == 3 and sorted(
        f for f in os.listdir(outs["torch"]) if f.endswith("_SR.png")) == names
    for name in names:
        want = np.asarray(Image.open(os.path.join(outs["jax"], name)).convert("RGB"))
        got = load_image_rgb(os.path.join(outs["torch"], name))
        assert got.shape == want.shape == (OUT, OUT, 3)
        if mode == "f32":
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name
        else:
            assert _psnr(got, want) >= (50 if mode == "bf16" else 40), name
    att = sorted(os.listdir(os.path.join(outs["jax"], "att")))
    assert att and sorted(os.listdir(os.path.join(outs["torch"], "att"))) == att
    for name in att:
        want = np.asarray(Image.open(os.path.join(outs["jax"], "att", name)).convert("RGB"))
        assert load_image_rgb(os.path.join(outs["torch"], "att", name)).shape == want.shape


def test_cli_calibrate_matches_jax(env):
    got = {}
    for pkg, main in (("jax", jcal.main), ("torch", tcal.main)):
        path = os.path.join(env["root"], f"scales_{pkg}.json")
        argv = common_args(env) + ["--data_dir", fresh_data(env, f"cal_{pkg}"), "--out", path,
                                   "--batch", "2", "--batches", "2"]
        if pkg == "jax":
            _jax(main, argv)
        else:
            main(argv + ["--device", "cpu"])
        with open(path) as f:
            got[pkg] = json.load(f)
    jax_s, port_s = got["jax"], got["torch"]
    assert port_s["_meta"]["weights_fingerprint"] == jax_s["_meta"]["weights_fingerprint"]
    for group in ("netg", "netgh"):
        assert sorted(port_s[group]) == sorted(jax_s[group])
        for k, v in jax_s[group].items():
            assert port_s[group][k] == pytest.approx(v, rel=1e-4), (group, k)
    assert "h_net2/residual_0/conv1" in port_s["netg"] and "img_net1/conv" in port_s["netg"]
    assert not any(k.startswith(("h_net3", "h_net4", "img_net2")) for k in port_s["netg"])


@pytest.fixture(scope="module")
def serve_files(env):
    # the text encoder's vocabulary size is the example set's
    words = {i: w for i, w in enumerate(["<end>", "big", "nose"]
                                        + [f"word{i}" for i in range(3, env["n_words"])])}
    vocab_pickle = os.path.join(env["root"], "vocab.pickle")
    with open(vocab_pickle, "wb") as f:
        pickle.dump([[], words, {w: i for i, w in words.items()}], f)
    return ["--cfg", env["cfg"], "--netg", os.path.join(env["ckpt"], "netG_epoch_7.pth"),
            "--vocab_pickle", vocab_pickle, "--text_encoder", env["text_encoder"],
            "--device", "cpu"]


def test_cli_serve_boots_x16_and_answers(env, serve_files):
    pipe, vocab, args = serve.boot(serve_files + ["--f32"])
    assert pipe.cfg.TREE.BRANCH_NUM == 5 and pipe.cfg.imsize == OUT
    httpd = serve.make_server(pipe, vocab, port=0, max_batch=2, max_delay_ms=10)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        img = np.random.default_rng(5).integers(0, 256, (20, 24, 3)).astype(np.uint8)
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/sr",
                                     data=encode_png(img), headers={"X-Caption": "big nose"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = np.asarray(Image.open(io.BytesIO(r.read())).convert("RGB"))
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(30)
    assert out.shape == (OUT, OUT, 3)
    jpipe = JSRPipeline.from_reference_checkpoints(
        jconfig_from_file(env["cfg"]), vocab.n_words, serve_files[3],
        text_encoder_path=env["text_encoder"], compute_dtype=jnp.float32)
    cap, n = serve.encode_caption_text("big nose", vocab, 6)
    lr = resize_pil_bicubic(img, (8, 8)).astype(np.float32) / 127.5 - 1.0
    want = np.asarray(jpipe.sr_uint8(lr[None], cap[None], np.asarray([n], np.int32)))[0]
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_cli_serve_int8_refuses_the_face_s8_scales(env, serve_files):
    """JAX's `serve --int8` takes face_s8_scales() whatever the family and
    its check_scales refuses them for x16; the port does the same, and says
    why."""
    from tgsr_tpu.cli import serve as jserve

    with pytest.raises(ValueError, match="match no conv"):
        jserve.main([a for a in serve_files if a not in ("--device", "cpu")] + ["--int8"])
    with pytest.raises(ValueError, match="shipped face S8 scales.*match no conv"):
        serve.boot(serve_files + ["--int8"])
