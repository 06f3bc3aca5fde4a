"""The port's exported serving programs (tgsr_tpu_torch/engine/aot.py,
cli/export_aot.py, cli/serve.py --aot) on the CPU, at the small x8
geometry of tests/torch_parity.py.

One seeded port init is carried to tgsr_tpu as flax trees
(`netg_variables` and its kin); the int8 scales come from the port's own
bfloat16 calibration, and both packages serve with them. Gates:

- the port's artifact against tgsr_tpu's (`export_serving` / `load_serving`
  on the CPU, the same numpy inputs): float32 uint8 within 1 level,
  bfloat16 >= 50 dB, int8 >= 40 dB (uint8 PSNR);
- bit for bit: the artifact against the live CPU `SRPipeline` at B = 1, 3
  and 5 from one symbolic artifact; a pinned artifact, padded by replicas
  and cropped, against the live pipeline at the pinned batch, and its
  refusal above the pin; a float artifact against the live float SR, and
  its host postprocess against the live uint8 SR;
- the `tgsr::` op nodes of each exported graph: 3 attention + 2 up-head
  (float32: `up_head`, bfloat16: `up_head_packed`), and int8 3 attention +
  42 `int8_conv` + 6 `glu_requant` at c = 2 GF_DIM (the kernel's
  `glu_requant_one` instance at full width) + 10 at c = GF_DIM
  (`glu_requant_pair`) + 26 `requant`: what on the card launches the kernels;
- meta.json against JAX's keys; an unlisted device refused; loading in a
  process that imports no model module;
- cli.export_aot from a bundle and from --cfg/--netg (--f32 --float, a
  pinned batch, both platforms); cli.serve --aot at --device cpu: POSTs, the
  vocabulary refusal, the batch clamp and native mode's 400.
"""

import io
import json
import os
import pickle
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgsr_tpu.engine import aot as jaot
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import (init_seeded, netg_variables, netgh_variables,
                                                 text_variables)
from tgsr_tpu_torch.cli import export_aot, serve
from tgsr_tpu_torch.data.codec import resize_pil_bicubic
from tgsr_tpu_torch.engine import aot
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests.torch_parity import SMALL, VOCAB, configs, inputs

torch.set_num_threads(1)
T, SIZE, NGF = SMALL["WORDS_NUM"], SMALL["BASE_SIZE"], SMALL["GF_DIM"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("float32", "bfloat16", "int8")
KERNEL_OPS = {
    "float32": {"word_pixel_attention": 3, "up_head": 2},
    "bfloat16": {"word_pixel_attention": 3, "up_head_packed": 2},
    "int8": {"word_pixel_attention": 3, "int8_conv": 42, "glu_requant_one": 6,
             "glu_requant_pair": 10, "requant": 26},
}
YAML = f"""# the small x8 geometry
CONFIG_NAME: 'narrow_S8'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: {SIZE}
GAN:
    GF_DIM: {NGF}
    CONDITION_DIM: {SMALL["CONDITION_DIM"]}
TEXT:
    EMBEDDING_DIM: {SMALL["EMBEDDING_DIM"]}
    WORDS_NUM: {T}
"""


def _kw(tag, scales):
    if tag == "float32":
        return {}
    return dict(compute_dtype=torch.bfloat16, quant_scales=scales if tag == "int8" else None)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, tcfg = configs()
    sds = init_seeded(tcfg, VOCAB, torch.Generator().manual_seed(0))
    text_sd, netg_sd, netgh_sd, _ = sds
    sds = (*sds[:3], 0.3)  # a blend weight that is not the init's
    trees = (text_variables(text_sd), netg_variables(netg_sd), netgh_variables(netgh_sd, 0.3))
    lr, cap, lens = inputs(4, SIZE, T, [T, 3, 0, 5], seed=11)
    scales = SRPipeline(tcfg, VOCAB, *sds, device="cpu",
                        compute_dtype=torch.bfloat16).calibrate_quant(lr, cap, lens)
    root = tmp_path_factory.mktemp("aot")
    pipes, arts, aots = {}, {}, {}
    for tag in PATHS:
        pipes[tag] = SRPipeline(tcfg, VOCAB, *sds, device="cpu", **_kw(tag, scales))
        arts[tag] = aot.export_serving(pipes[tag], str(root / tag))
        aots[tag] = aot.AOTPipeline(arts[tag], device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, sds=sds, trees=trees, scales=scales, pipes=pipes,
                arts=arts, aots=aots, root=root)


@pytest.fixture(scope="module")
def pinned(setup):
    """cli.export_aot from --cfg/--netg .pth files: float32, a float output,
    a batch pinned at 4, loadable on the CPU and the card; with the live
    pipeline of the same files."""
    root = str(setup["root"] / "pinned")
    ck = _checkpoints(setup, os.path.join(root, "ck"))
    meta = export_aot.main(["--cfg", os.path.join(ck, "narrow.yml"),
                            "--netg", os.path.join(ck, "netG_epoch_7.pth"),
                            "--text_encoder", os.path.join(ck, "text_encoder.pth"),
                            "--out", os.path.join(root, "aot"), "--f32", "--float",
                            "--batch", "4", "--platforms", "cpu,cuda", "--device", "cpu"])
    live = SRPipeline.from_reference_checkpoints(
        setup["tcfg"], VOCAB, os.path.join(ck, "netG_epoch_7.pth"),
        text_encoder_path=os.path.join(ck, "text_encoder.pth"), device="cpu")
    path = os.path.join(root, "aot")
    return dict(meta=meta, live=live, path=path, pipe=aot.AOTPipeline(path, device="cpu"))


def _psnr_u8(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("tag", PATHS)
def test_artifact_matches_jax_artifact(setup, tag, tmp_path):
    """Both packages' artifacts of the same weights on the same inputs; the
    port's meta.json carries JAX's keys with JAX's values."""
    jkw = {} if tag == "float32" else dict(compute_dtype=jnp.bfloat16)
    if tag == "int8":
        jkw["quant_scales"] = setup["scales"]
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], **jkw)
    call, jmeta = jaot.load_serving(jaot.export_serving(jpipe, str(tmp_path / "jax")))
    lr, cap, lens = inputs(4, SIZE, T, [T, 2, 0, 4], seed=5)
    ref = np.asarray(call(lr, cap, lens))
    got = setup["aots"][tag].sr_uint8(lr, cap, lens)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (4, 64, 64, 3)
    if tag == "float32":
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    else:
        assert _psnr_u8(got, ref) >= (50.0 if tag == "bfloat16" else 40.0)
    with open(os.path.join(setup["arts"][tag], "meta.json")) as f:
        meta = json.load(f)
    assert {k: meta[k] for k in jmeta} == jmeta
    assert meta["torch"] == torch.__version__


@pytest.mark.parametrize("tag", PATHS)
def test_artifact_equals_live_pipeline(setup, tag):
    """One symbolic artifact at B = 1, 3 and 5, bit for bit the live CPU
    pipeline's uint8 SR (the same ATen ops and plain kernel versions)."""
    pipe = setup["aots"][tag]
    assert pipe.meta["batch"] == "symbolic" and pipe.cfg.scale == 8
    assert bool(pipe.quant_scales) == (tag == "int8")
    for b in (1, 3, 5):
        lr, cap, lens = inputs(b, SIZE, T, [T, 0, 3, 1, 6][:b], seed=b)
        np.testing.assert_array_equal(pipe.sr_uint8(lr, cap, lens),
                                      setup["pipes"][tag].sr_uint8(lr, cap, lens))
    assert pipe.sr_uint8(np.zeros((0, SIZE, SIZE, 3), np.float32), np.zeros((0, T)),
                         np.zeros(0)).shape == (0, 64, 64, 3)


@pytest.mark.parametrize("tag", PATHS)
def test_graph_holds_the_kernel_ops(setup, tag):
    """The tgsr:: op nodes of the saved program: the kernels it launches on
    the card, one node a launch."""
    found = Counter()
    for node in setup["aots"][tag].module.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("tgsr."):
            name = str(node.target).split(".")[1]
            if name == "glu_requant":  # the kernel's instance by the GLU's channels
                c = node.args[0].meta["val"].shape[-1] // 2
                name = {2 * NGF: "glu_requant_one", NGF: "glu_requant_pair"}[c]
            found[name] += 1
    assert dict(found) == KERNEL_OPS[tag]


def test_pinned_artifact_pads_crops_and_refuses(pinned):
    """A pinned batch runs every call at the pin: fewer images are padded by
    replicas and cropped (bit for bit the live pipeline at the pin), more are
    refused; cli.serve clamps its batch plan to the pin."""
    pipe, live = pinned["pipe"], pinned["live"]
    assert pinned["meta"]["batch"] == 4 and pipe.graph_batch(1) == 4
    for b in (1, 3, 4):
        lr, cap, lens = inputs(b, SIZE, T, [T, 2, 0, 4][:b], seed=20 + b)
        sel = np.arange(4) % b
        ref = live.sr_uint8(lr[sel], cap[sel], lens[sel])[:b]
        np.testing.assert_array_equal(pipe.sr_uint8(lr, cap, lens), ref)
    lr, cap, lens = inputs(5, SIZE, T, [T] * 5, seed=25)
    with pytest.raises(ValueError, match="exceeds the artifact's pinned batch 4"):
        pipe.sr_uint8(lr, cap, lens)
    assert serve.aot_max_batch(pipe.meta, 32) == 4 and serve.aot_max_batch(pipe.meta, 2) == 2
    assert serve.aot_max_batch({"batch": "symbolic"}, 32) == 32


def test_float_artifact(pinned):
    """--float: the program returns the float32 SR in [-1, 1], bit for bit
    the live pipeline's, and AOTPipeline's host postprocess gives its uint8
    images."""
    assert pinned["meta"]["uint8"] is False and pinned["meta"]["compute_dtype"] == "float32"
    module = pinned["pipe"].module
    lr, cap, lens = inputs(4, SIZE, T, [T, 1, 4, 0], seed=30)
    with torch.inference_mode():
        sr = module(torch.from_numpy(lr), torch.from_numpy(cap).long(),
                    torch.from_numpy(lens).long())
    assert sr.dtype == torch.float32
    torch.testing.assert_close(sr, pinned["live"](lr, cap, lens)["sr"], rtol=0, atol=0)
    np.testing.assert_array_equal(pinned["pipe"].sr_uint8(lr, cap, lens),
                                  pinned["live"].sr_uint8(lr, cap, lens))


def test_devices_and_platforms(setup, pinned):
    """An artifact loads on the device types it lists and no other; export
    takes cpu and cuda only."""
    with pytest.raises(ValueError, match="not for cuda"):
        aot.load_serving(setup["arts"]["float32"], "cuda")
    with pytest.raises(ValueError, match="platforms"):
        aot.export_serving(setup["pipes"]["float32"], str(setup["root"] / "x"),
                           platforms=["tpu"])
    assert pinned["meta"]["platforms"] == ["cpu", "cuda"]
    with pytest.raises(ValueError, match="not for meta"):
        aot.load_serving(pinned["path"], "meta")


def test_loading_needs_only_the_op_registrations(setup, tmp_path):
    """A process that loads and serves the int8 artifact imports the op
    registrations and no model module, and gives the live pipeline's bits."""
    lr, cap, lens = inputs(3, SIZE, T, [T, 0, 2], seed=50)
    np.savez(tmp_path / "in.npz", lr=lr, cap=cap, lens=lens)
    code = (
        "import sys, numpy as np\n"
        "from tgsr_tpu_torch.engine.aot import AOTPipeline\n"
        f"d = np.load({str(tmp_path / 'in.npz')!r})\n"
        f"out = AOTPipeline({setup['arts']['int8']!r}, device='cpu').sr_uint8("
        "d['lr'], d['cap'], d['lens'])\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out)\n"
        "mods = [m for m in sys.modules if m.startswith('tgsr_tpu')]\n"
        "assert 'tgsr_tpu_torch.ops.library' in mods, mods\n"
        "assert not any(m.startswith(('tgsr_tpu_torch.models', 'tgsr_tpu_torch.engine.inference',"
        " 'tgsr_tpu.')) or m == 'tgsr_tpu' for m in mods), mods\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(tmp_path),
                   timeout=300)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  setup["pipes"]["int8"].sr_uint8(lr, cap, lens))


def _checkpoints(setup, root):
    """The small geometry's YAML, netG / netGH / text encoder .pth files."""
    text_sd, netg_sd, netgh_sd, _ = setup["sds"]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "narrow.yml"), "w") as f:
        f.write(YAML)
    torch.save(netg_sd, os.path.join(root, "netG_epoch_7.pth"))
    torch.save(netgh_sd, os.path.join(root, "netGH_epoch_7.pth"))
    torch.save(text_sd, os.path.join(root, "text_encoder.pth"))
    return root


def test_cli_export_from_bundle(setup, tmp_path):
    """cli.export_aot from an int8 bundle (its scales and dtype kept), bit
    for bit the pipeline it was saved from; the export from --cfg/--netg is
    the `pinned` fixture's."""
    bundle = setup["pipes"]["int8"].save_artifact(str(tmp_path / "bundle"))
    meta = export_aot.main(["--artifact", bundle, "--out", str(tmp_path / "a"),
                            "--device", "cpu"])
    assert meta["quantized"] and meta["compute_dtype"] == "bfloat16"
    lr, cap, lens = inputs(3, SIZE, T, [T, 2, 5], seed=60)
    np.testing.assert_array_equal(
        aot.AOTPipeline(str(tmp_path / "a"), device="cpu").sr_uint8(lr, cap, lens),
        setup["pipes"]["int8"].sr_uint8(lr, cap, lens))
    with pytest.raises(SystemExit, match="--artifact OR --cfg"):
        export_aot.main(["--out", str(tmp_path / "c"), "--device", "cpu"])


WORDS = ["<end>", "a", "big", "nose", "smiling"] + [f"w{i}" for i in range(VOCAB - 5)]


def _pickle(path, words):
    ixtoword = dict(enumerate(words))
    with open(path, "wb") as f:
        pickle.dump([[], ixtoword, {w: i for i, w in ixtoword.items()}], f)
    return path


def _png(a):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


def _post(port, body, caption, query=""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sr{query}", data=body,
                                 headers={"X-Caption": caption}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_aot(pinned, tmp_path, capsys):
    """cli.serve --aot at --device cpu: the boot's refusals (a vocabulary of
    another size, --int8, no pickle), the clamp of --max_batch to a pinned
    artifact, concurrent POSTs bit for bit the artifact's direct call at the
    pin, and native mode's 400."""
    path = pinned["path"]
    vocab_pkl = _pickle(str(tmp_path / "vocab.pickle"), WORDS)
    small_pkl = _pickle(str(tmp_path / "small.pickle"), WORDS[:5])
    with pytest.raises(SystemExit, match="exported with a 41-word vocabulary"):
        serve.boot(["--aot", path, "--vocab_pickle", small_pkl, "--device", "cpu"])
    with pytest.raises(SystemExit, match="drop --int8/--f32"):
        serve.boot(["--aot", path, "--vocab_pickle", vocab_pkl, "--int8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --vocab_pickle"):
        serve.boot(["--aot", path, "--device", "cpu"])
    capsys.readouterr()
    pipe, vocab, args = serve.boot(["--aot", path, "--vocab_pickle", vocab_pkl,
                                    "--max_batch", "16", "--device", "cpu"])
    assert "clamping --max_batch 16 -> 4" in capsys.readouterr().out
    assert args.max_batch == 4 and isinstance(pipe, aot.AOTPipeline)
    assert not hasattr(pipe, "sr_arbitrary")
    httpd = serve.make_server(pipe, vocab, port=0, max_batch=args.max_batch, max_delay_ms=20)
    httpd.batcher.warmup()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        rng = np.random.default_rng(7)
        imgs = [rng.integers(0, 256, (24, 24, 3)).astype(np.uint8) for _ in range(3)]
        results = {}

        def worker(i):
            results[i] = _post(port, _png(imgs[i]), "a big smiling nose")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        cap, n = serve.encode_caption_text("a big smiling nose", vocab, T)
        for i in range(3):
            status, body = results[i]
            assert status == 200
            lr = resize_pil_bicubic(imgs[i], (SIZE, SIZE)).astype(np.float32) / 127.5 - 1.0
            direct = pipe.sr_uint8(lr[None], cap[None], np.asarray([n]))[0]
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))), direct)
        status, body = _post(port, _png(imgs[0]), "a nose", "?mode=native")
        assert status == 400 and "native mode unavailable" in json.loads(body)["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=10)
