"""The port's DAMSM R-precision (tgsr_tpu_torch.cli.eval_rank,
engine/evaluator.rank_r_precision, data/datasets.TextSRGTDataset) against
tgsr_tpu's on the CPU, on one fixture: 7 generated 64 px PNGs and their
face attribute captions (testset.txt in the 'name|flags' layout the
reference's TextSRGTDataset reads, a testset.pickle vocabulary), JAX-init
encoders written by JAX's save_variables (the text encoder and a
SimpleCNNEncoder at the default config's width, nef 256).

Both CLIs print the same JSON line: n, seeded_encoders and R@1 / R@5
exactly (the rankings agree; the similarity matrices within rtol 1e-5).
JAX's CLI indexes the text encoder's embedding table inside its jitted
embed, which fails on the numpy leaves `load_variables` returns (any
--net_e file); the test hands it device arrays (ROADMAP Queue C).
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints.io import save_variables as jax_save_variables
from tgsr_tpu.cli import eval_rank as jax_eval_rank
from tgsr_tpu.data.datasets import TextSRGTDataset as JTextSRGTDataset
from tgsr_tpu.engine.evaluator import rank_r_precision as jax_rank
from tgsr_tpu.models.image_encoder import SimpleCNNEncoder as JSimpleCNNEncoder
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu_torch.cli import eval_rank
from tgsr_tpu_torch.data.codec import encode_png
from tgsr_tpu_torch.data.datasets import TextSRGTDataset
from tgsr_tpu_torch.data.tokenizer import build_dictionary
from tgsr_tpu_torch.engine.evaluator import rank_r_precision
from tests.torch_cli_data import ATTRS, attr_rows, face_image

torch.set_num_threads(1)
N = 7


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_rank")
    rng = np.random.default_rng(11)
    data, images = root / "data", root / "sr"
    data.mkdir()
    images.mkdir()
    names = [f"{i:06d}" for i in range(N)]
    rows = attr_rows(rng, N, (2, 4), test_rows=0)
    with open(data / "testset.txt", "w") as f:
        f.write(" ".join(ATTRS) + " \n")
        for name, r in zip(names, rows):
            f.write(f"{name}.png|{name}.jpg " + " ".join(map(str, r)) + "\n")
    for name in names:
        (images / f"{name}.png").write_bytes(encode_png(face_image(rng, 64, 64)))
    caps = [[ATTRS[k] for k in np.nonzero(r)[0]] for r in rows]
    train, _, vocab = build_dictionary(caps, [])
    with open(data / "testset.pickle", "wb") as f:
        pickle.dump([train, vocab.ixtoword, vocab.wordtoix], f, protocol=2)
    tv = JTextEncoder(vocab_size=vocab.n_words, nhidden=256).init(
        jax.random.PRNGKey(5), jnp.ones((1, 18), jnp.int32), jnp.ones((1,), jnp.int32))
    cv = JSimpleCNNEncoder(nef=256).init(jax.random.PRNGKey(6), jnp.zeros((1, 64, 64, 3)))
    jax_save_variables(str(root / "text_encoder.msgpack"), tv)
    jax_save_variables(str(root / "image_encoder.msgpack"), cv)
    base = ["--data_dir", str(data), "--image_dir", str(images), "--vocab_pickle",
            str(data / "testset.pickle"), "--imsize", "64", "--batch", "4"]
    enc = ["--net_e", str(root / "text_encoder.msgpack"), "--image_encoder",
           str(root / "image_encoder.msgpack"), "--simple-cnn"]
    return dict(root=root, data=str(data), images=str(images), base=base, enc=enc,
                vocab=vocab)


def test_dataset_matches_jax(env):
    """TextSRGTDataset: the same names, captions, tokens and centre crops
    (64 px PNGs at imsize 64, and zero-padded to 80)."""
    for imsize in (64, 80):
        port = TextSRGTDataset(env["vocab"], env["data"], env["images"], dataset="face",
                               imsize=imsize)
        ref = JTextSRGTDataset(env["vocab"], env["data"], env["images"], dataset="face",
                               imsize=imsize)
        assert port.filenames == ref.filenames and port.captions == ref.captions
        for i in range(N):
            a, b = port[i], ref[i]
            np.testing.assert_array_equal(a.hr, b.hr)
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert a.length == b.length and a.key == b.key


def test_cli_line_matches_jax(env, tmp_path, capsys, monkeypatch):
    """Both CLIs on the same files: the same JSON line (and the --out file)."""
    from tgsr_tpu.checkpoints import io as jax_io

    out = str(tmp_path / "rank.json")
    port = eval_rank.main(env["base"] + env["enc"] + ["--device", "cpu", "--out", out])
    load = jax_io.load_variables
    monkeypatch.setattr(jax_io, "load_variables",
                        lambda path: jax.tree.map(jnp.asarray, load(path)))
    ref = jax_eval_rank.main(env["base"] + env["enc"])
    assert port == ref
    assert set(port) == {"n", "seeded_encoders", "word_r@1", "sent_r@1", "word_r@5",
                         "sent_r@5"} and port["seeded_encoders"] == []
    with open(out) as f:
        assert json.loads(f.read()) == port
    assert json.dumps(port) in capsys.readouterr().out


def test_rank_r_precision_matches_jax():
    """rank_r_precision on the same embeddings: R@1, R@3, and the
    similarity matrices of its device half."""
    from tgsr_tpu.engine.evaluator import _rank_sims as jax_sims
    from tgsr_tpu_torch.engine.evaluator import _rank_sims

    rng = np.random.default_rng(3)
    n, t, e = 9, 6, 16
    x = (rng.normal(size=(n, 289, e)), rng.normal(size=(n, e)), rng.normal(size=(n, t, e)),
         rng.normal(size=(n, e)))
    x = [a.astype(np.float32) for a in x]
    # captions correlate with their images, so that R@k is neither 0 nor 1
    x[3] = x[3] + 0.8 * x[1]
    lens = rng.integers(1, t + 1, n).astype(np.int32)
    for k in (1, 3):
        got = rank_r_precision(*x, lens, (5.0, 5.0, 10.0), top_k=k)
        assert got == jax_rank(*x, lens, (5.0, 5.0, 10.0), top_k=k)
    ws, ss = _rank_sims(*map(torch.from_numpy, x), torch.from_numpy(lens), 5.0, 5.0, 10.0)
    jws, jss = jax_sims(*x, lens, jnp.float32(5.0), jnp.float32(5.0), jnp.float32(10.0))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("captions", [1, 2, 4])
def test_rank_sims_in_caption_blocks_match_jax(captions, monkeypatch):
    """_rank_sims takes the captions in blocks of `captions` (the last one
    short) against every image: the same matrices as JAX's one call, the
    same R@k, and TF32 off while it computes."""
    from tgsr_tpu.engine.evaluator import _rank_sims as jax_sims
    from tgsr_tpu_torch.engine import evaluator
    from tgsr_tpu_torch.losses import damsm

    rng = np.random.default_rng(4)
    n, t, e = 9, 6, 16
    x = [rng.normal(size=s).astype(np.float32)
         for s in ((n, 289, e), (n, e), (n, t, e), (n, e))]
    x[3] = x[3] + 0.8 * x[1]
    lens = rng.integers(1, t + 1, n).astype(np.int32)
    monkeypatch.setattr(evaluator, "RANK_BLOCK_ELEMS", captions * n * t * 289)
    blocks = []
    words_similarity = damsm.words_similarity

    def spy(feats, words, *a):
        blocks.append((len(words), torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32))
        return words_similarity(feats, words, *a)

    monkeypatch.setattr(evaluator, "words_similarity", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ws, ss = evaluator._rank_sims(*map(torch.from_numpy, x), torch.from_numpy(lens),
                                  5.0, 5.0, 10.0)
    sizes = [captions] * (n // captions) + ([n % captions] if n % captions else [])
    assert blocks == [(c, False, False) for c in sizes] and torch.backends.cudnn.allow_tf32
    jws, jss = jax_sims(*x, lens, jnp.float32(5.0), jnp.float32(5.0), jnp.float32(10.0))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5, atol=1e-6)
    for k in (1, 3):
        assert rank_r_precision(*x, lens, (5.0, 5.0, 10.0), top_k=k) == jax_rank(
            *x, lens, (5.0, 5.0, 10.0), top_k=k)


def test_seeded_and_small_runs(env, capsys):
    """No encoder files: a warning and seeded_encoders ['text', 'image'];
    R@k capped at n; an image encoder of the other family is refused."""
    res = eval_rank.main(env["base"] + ["--simple-cnn", "--device", "cpu"])
    assert res["seeded_encoders"] == ["text", "image"] and res["n"] == N
    assert "WARNING: text/image encoder(s) at seeded random init" in capsys.readouterr().out
    small = env["root"] / "small"
    small.mkdir()
    with open(os.path.join(env["data"], "testset.txt")) as f:
        lines = f.readlines()
    (small / "testset.txt").write_text("".join(lines[:4]))
    argv = list(env["base"])
    argv[argv.index("--data_dir") + 1] = str(small)
    res = eval_rank.main(argv + env["enc"] + ["--device", "cpu"])
    assert res["n"] == 3 and set(res) == {"n", "seeded_encoders", "word_r@1", "sent_r@1",
                                          "word_r@3", "sent_r@3"}
    with pytest.raises(SystemExit, match="pass --simple-cnn"):
        eval_rank.main(env["base"] + [a for a in env["enc"] if a != "--simple-cnn"]
                       + ["--device", "cpu"])
