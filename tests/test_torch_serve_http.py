"""The port's HTTP serving CLI (tgsr_tpu_torch/cli/serve.py) on the CPU, the
counterpart of tests/test_serve_http.py: concurrent POSTs batch through
BatchingServer and come back as PNGs of the direct pipeline path; bad
requests; JPEG and every PNG form answered as their pixels; native mode;
main's argument checks; the boot paths
(--cfg/--netg/--vocab_pickle, --artifact); resolve_net_e's priority order
against tgsr_tpu's.

Gates: a fixed-size response within one uint8 level of the direct
`sr_uint8` on the same codec-resized LR (PyTorch's CPU convolutions sum in
a batch-dependent order, tests/test_torch_serving.py); a native response
bit for bit `sr_arbitrary`; captions, vocab and NET_E sources equal to
tgsr_tpu's. Images are made and read with PIL here, as a client would.
"""

import io
import json
import os
import pickle
import signal
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tgsr_tpu.checkpoints import shipped as jshipped
from tgsr_tpu.cli.serve import encode_caption_text as jencode_caption_text
from tgsr_tpu.config import Config as JConfig
from tgsr_tpu.data import tokenizer as jtokenizer
from tgsr_tpu.data.tokenizer import Vocab as JVocab
from tgsr_tpu_torch.checkpoints import shipped
from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
from tgsr_tpu_torch.cli import serve
from tgsr_tpu_torch.config import Config, GanConfig, TextConfig, TreeConfig
from tgsr_tpu_torch.data.codec import resize_pil_bicubic
from tgsr_tpu_torch.data.tokenizer import Vocab
from tgsr_tpu_torch.engine.inference import SRPipeline
from tgsr_tpu_torch.utils.preemption import graceful_sigterm
from tests.test_torch_image_fixtures import photo
from tests.torch_png_writer import write_png

torch.set_num_threads(1)
T, SIZE = 6, 8  # caption slots and LR size of the narrow x8 tree
WORDS = ["<end>", "a", "big", "nose", "smiling"]
YAML = """# a narrow x8 eval config
CONFIG_NAME: 'narrow_S8'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: 8
TRAIN:
    FLAG: False
    NET_E: ''
GAN:
    GF_DIM: 8
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
"""


def _cfg():
    return Config(TREE=TreeConfig(4, SIZE), GAN=GanConfig(8, 10, 2), TEXT=TextConfig(32, T))


def _vocab():
    return Vocab(dict(enumerate(WORDS)), {w: i for i, w in enumerate(WORDS)})


@pytest.fixture(scope="module")
def http_srv():
    cfg = _cfg()
    pipe = SRPipeline(cfg, 41, *init_seeded(cfg, 41, torch.Generator().manual_seed(0)),
                      device="cpu")
    httpd = serve.make_server(pipe, _vocab(), port=0, max_batch=4, max_delay_ms=10)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    httpd.batcher.close()
    t.join(timeout=10)
    assert not t.is_alive()


def _png(a, fmt="PNG"):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format=fmt)
    return buf.getvalue()


def _post(port, body, caption, query=""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sr{query}", data=body,
                                 headers={"X-Caption": caption}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post_error(port, body, query="", path="/sr"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}{query}", data=body,
                                 headers={"X-Caption": "a"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    return e.value.code, json.loads(e.value.read())["error"]


def test_http_round_trip_matches_direct(http_srv):
    port = http_srv.server_address[1]
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (40, 40, 3)).astype(np.uint8) for _ in range(6)]
    caption = "A big smiling nose"
    results = {}

    def worker(i):
        results[i] = _post(port, _png(imgs[i]), caption)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    cap, n = serve.encode_caption_text(caption, _vocab(), T)
    pipe = http_srv.batcher.pipeline
    for i in range(6):
        status, kind, body = results[i]
        assert status == 200 and kind == "image/png"
        out = np.asarray(Image.open(io.BytesIO(body)))
        assert out.shape == (64, 64, 3)
        lr = resize_pil_bicubic(imgs[i], (SIZE, SIZE)).astype(np.float32) / 127.5 - 1.0
        direct = pipe.sr_uint8(lr[None], cap[None], np.asarray([n], np.int32))[0]
        assert np.abs(out.astype(int) - direct.astype(int)).max() <= 1
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz?x=1", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["requests"] >= 6 and health["batches"] >= 2
    assert sum(health["batch_hist"].values()) == health["batches"]
    assert health["p50_ms"] > 0 and health["p99_ms"] >= health["p50_ms"]


def test_http_native_mode(http_srv):
    port = http_srv.server_address[1]
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (43, 26, 3)).astype(np.uint8)  # crops to 40 x 24
    status, _, body = _post(port, _png(img), "a big nose", "?mode=native")
    out = np.asarray(Image.open(io.BytesIO(body)))
    assert status == 200 and out.shape == (40 * 8, 24 * 8, 3)
    cap, n = serve.encode_caption_text("a big nose", _vocab(), T)
    lr = img[:40, :24].astype(np.float32) / 127.5 - 1.0
    direct = http_srv.batcher.pipeline.sr_arbitrary(lr[None], cap[None],
                                                    np.asarray([n], np.int32), bucket=64)[0]
    np.testing.assert_array_equal(out, direct)
    # the caption may also come in the query
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sr?mode=native&caption=a+big+nose",
                                 data=_png(img), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(r.read()))), direct)


def test_http_bad_requests(http_srv):
    port = http_srv.server_address[1]
    rng = np.random.default_rng(6)
    code, err = _post_error(port, b"not an image")
    assert code == 400 and "not a PNG" in err
    jpeg = _png(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8), "JPEG")
    code, err = _post_error(port, jpeg[:len(jpeg) // 2])  # JPEG is served; a truncated one not
    assert code == 400 and "truncated JPEG" in err
    code, err = _post_error(port, _png(np.zeros((16, 16, 3), np.uint8), "GIF"))
    assert code == 400 and "GIF" in err
    good = _png(np.zeros((16, 16, 3), np.uint8))
    bad_ihdr = good[:8] + struct.pack(">I", 12) + good[12:28] + struct.pack(
        ">I", zlib.crc32(good[12:28])) + good[33:]
    code, err = _post_error(port, bad_ihdr)
    assert code == 400 and "IHDR" in err
    z = zlib.compressobj(9)
    stream = b"".join(z.compress(bytes(1 << 20)) for _ in range(64)) + z.flush()
    bomb = (good[:33] + struct.pack(">I", len(stream)) + b"IDAT" + stream
            + struct.pack(">I", zlib.crc32(b"IDAT" + stream)) + good[-12:])
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sr", data=bomb, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:  # inflated only to 16 x 16: black
        assert r.status == 200 and Image.open(io.BytesIO(r.read())).size == (8 * SIZE, 8 * SIZE)
    code, err = _post_error(port, _png(np.zeros((16, 16, 3), np.uint8)), "?mode=wat")
    assert code == 400 and "mode" in err
    code, err = _post_error(port, _png(np.zeros((4, 4, 3), np.uint8)), "?mode=native")
    assert code == 400 and "tile" in err
    code, _ = _post_error(port, b"", path="/nope")
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    assert e.value.code == 404


@pytest.mark.parametrize("query", ["", "?mode=native"])
def test_http_jpeg_and_png_forms_answer_as_their_pixels(http_srv, query):
    """A JPEG (baseline and progressive), a 16-bit RGB PNG and an Adam7
    interlaced palette PNG are answered with the bytes the same pixels
    (PIL's reading of the body) get when sent as an 8-bit PNG, in fixed and
    in native mode. The requests go one at a time, so that each is a batch
    of one."""
    port = http_srv.server_address[1]
    rng = np.random.default_rng(21)
    img = photo(rng, 43, 37)
    bodies = {}
    for name, kw in (("baseline", {}), ("progressive", {"progressive": True})):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, **kw)
        bodies[name] = buf.getvalue()
    px16 = img.astype(np.int64) * 257 + rng.integers(0, 256, img.shape)
    bodies["png16"] = write_png(px16, 2, 16)
    bodies["palette_adam7"] = write_png(rng.integers(0, 16, (43, 37, 1)), 3, 4, interlace=True,
                                        palette=rng.integers(0, 256, (16, 3)))
    for name, body in bodies.items():
        pixels = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        got = _post(port, body, "a big nose", query)
        want = _post(port, _png(pixels), "a big nose", query)
        assert got[0] == want[0] == 200
        assert got[2] == want[2], name


@pytest.mark.parametrize("text", ["A big UNKNOWN nose", "", "Smiling, big-nose!",
                                  "a big nose a big nose smiling a"])
def test_encode_caption_text_matches_jax(text):
    """The same ids and length as tgsr_tpu's; a caption longer than T keeps
    the same sorted subsample from the same seeded generator."""
    jvocab = JVocab(dict(enumerate(WORDS)), {w: i for i, w in enumerate(WORDS)})
    cap, n = serve.encode_caption_text(text, _vocab(), 6, np.random.default_rng(3))
    ids = jvocab.encode_tokens(jtokenizer.tokenize_caption(text))
    want, want_n = jtokenizer.encode_caption(ids, 6, np.random.default_rng(3))
    assert cap.dtype == np.int32 and cap.tolist() == want.tolist() and n == want_n
    if len(ids) <= 6:  # no subsample: JAX's own encode_caption_text, unseeded
        ref, ref_n = jencode_caption_text(text, jvocab, 6)
        assert cap.tolist() == ref.tolist() and n == ref_n


def test_serve_main_arg_validation():
    with pytest.raises(SystemExit, match="artifact OR"):
        serve.main(["--cfg", "x.yml"])
    with pytest.raises(SystemExit, match="vocab_pickle"):
        serve.main(["--aot", "/tmp/nowhere"])
    with pytest.raises(SystemExit, match="export time"):
        serve.main(["--aot", "/tmp/nowhere", "--vocab_pickle", "v.pickle", "--int8"])
    # --aot is served since the export entry points were ported: a directory
    # without an exported program fails on its meta.json
    with pytest.raises(FileNotFoundError, match="meta.json"):
        serve.main(["--aot", "/tmp/nowhere", "--vocab_pickle", "v.pickle"])
    with pytest.raises(SystemExit, match="scales selects int8"):
        serve.main(["--cfg", "x.yml", "--scales", "s.json", "--int8"])
    with pytest.raises(SystemExit, match="scales selects int8"):
        serve.main(["--artifact", "/tmp/nowhere", "--scales", "s.json"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded .pth checkpoints, a vocab pickle (testset layout) and a YAML."""
    d = tmp_path_factory.mktemp("serve")
    sds = init_seeded(_cfg(), len(WORDS), torch.Generator().manual_seed(1))
    torch.save(sds[1], d / "netG_epoch_7.pth")
    torch.save(sds[2], d / "netGH_epoch_7.pth")
    torch.save(sds[0], d / "text_encoder.pth")
    v = _vocab()
    with open(d / "testset.pickle", "wb") as f:
        pickle.dump([[[1, 2]], v.ixtoword, v.wordtoix], f)
    (d / "eval.yml").write_text(YAML)
    return d, sds


def test_boot_from_cfg_and_checkpoints(files):
    d, sds = files
    argv = ["--cfg", str(d / "eval.yml"), "--netg", str(d / "netG_epoch_7.pth"),
            "--vocab_pickle", str(d / "testset.pickle"), "--device", "cpu"]
    pipe, vocab, args = serve.boot(argv + ["--text_encoder", str(d / "text_encoder.pth"),
                                           "--f32"])
    assert vocab.n_words == len(WORDS) and pipe.vocab_size == len(WORDS)
    assert pipe.cfg.TREE.BASE_SIZE == SIZE and pipe.cfg.CONFIG_NAME == "narrow_S8"
    assert pipe.compute_dtype == torch.float32 and not pipe.quant_scales
    direct = SRPipeline(_cfg(), len(WORDS), *sds, device="cpu")
    rng = np.random.default_rng(2)
    lr = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    cap, lens = np.array([[1, 2, 0, 0, 0, 0], [3, 4, 1, 0, 0, 0]]), np.array([2, 3])
    np.testing.assert_array_equal(pipe.sr_uint8(lr, cap, lens), direct.sr_uint8(lr, cap, lens))
    bf16, _, _ = serve.boot(argv)  # no NET_E source for a 5-word vocab: seeded, bfloat16
    assert bf16.compute_dtype == torch.bfloat16
    # int8 with float32 compute is served; the shipped face_S8 scales then
    # refuse these seeded weights by their fingerprint, as with bfloat16
    with pytest.raises(ValueError, match="fingerprint"):
        serve.boot(argv + ["--f32", "--int8"])


def test_boot_from_artifact(files, tmp_path):
    d, sds = files
    pipe = SRPipeline(_cfg(), len(WORDS), *sds, device="cpu")
    pipe.save_artifact(str(tmp_path / "bundle"), vocab=_vocab())
    loaded, vocab, _ = serve.boot(["--artifact", str(tmp_path / "bundle"), "--device", "cpu"])
    assert vocab.wordtoix == _vocab().wordtoix and loaded.compute_dtype == torch.float32
    pipe.save_artifact(str(tmp_path / "novocab"))
    with pytest.raises(SystemExit, match="vocab.json"):
        serve.boot(["--artifact", str(tmp_path / "novocab"), "--device", "cpu"])
    _, vocab, _ = serve.boot(["--artifact", str(tmp_path / "novocab"), "--device", "cpu",
                              "--vocab_pickle", str(d / "testset.pickle")])
    assert vocab.n_words == len(WORDS)
    with pytest.raises(ValueError, match="quant_scales"):
        serve.boot(["--artifact", str(tmp_path / "bundle"), "--device", "cpu", "--int8"])


def test_resolve_net_e_priority_matches_jax(tmp_path, monkeypatch):
    """flag > cfg NET_E on disk > shipped trained NET_E (vocab 41) >
    seeded, as tgsr_tpu's resolve_net_e, and the same shipped file."""
    on_disk = tmp_path / "text_encoder.pth"
    on_disk.write_bytes(b"")
    cases = [
        dict(explicit="", seeded=True, net_e=str(on_disk), vocab=41),
        dict(explicit="mine.pth", seeded=False, net_e=str(on_disk), vocab=41),
        dict(explicit="", seeded=False, net_e=str(on_disk), vocab=41),
        dict(explicit="", seeded=False, net_e=str(tmp_path / "missing.pth"), vocab=41),
        dict(explicit="", seeded=False, net_e="", vocab=41),
        dict(explicit="", seeded=False, net_e="", vocab=40),
    ]
    got = []
    for c in cases:
        tcfg, jcfg = Config(), JConfig()
        tcfg.TRAIN.NET_E = jcfg.TRAIN.NET_E = c["net_e"]
        port = shipped.resolve_net_e(tcfg, c["explicit"], c["vocab"], seeded=c["seeded"])
        ref = jshipped.resolve_net_e(jcfg, c["explicit"], c["vocab"], seeded=c["seeded"])
        assert (port[0] is None) == (ref[0] is None)
        if ref[0] is not None:
            assert os.path.realpath(port[0]) == os.path.realpath(ref[0])
        got.append(port[1].split(" ")[0])
    assert got == ["seeded", "--text_encoder", "cfg", "shipped", "shipped", "seeded"]
    assert shipped.shipped_net_e(41) and shipped.shipped_net_e(40) is None


def test_graceful_sigterm():
    """SIGTERM raises KeyboardInterrupt in the main thread, the previous
    handler comes back; off the main thread the manager yields False."""
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(KeyboardInterrupt):
        with graceful_sigterm() as installed:
            assert installed
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(5)  # interrupted by the handler long before 5 s
            pytest.fail("SIGTERM handler did not fire")
    assert signal.getsignal(signal.SIGTERM) is prev
    out = []

    def run():
        with graceful_sigterm() as installed:
            out.append(installed)

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    assert out == [False]
