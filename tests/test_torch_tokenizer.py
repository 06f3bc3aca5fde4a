"""tgsr_tpu_torch/data/tokenizer.py and cli/eval_rank.py `load_vocab`
against tgsr_tpu's on the same inputs: tokens, dictionaries and encoded
captions equal, the long-caption subsample drawn from the same seeded
generator equal; `load_vocab` on both pickle layouts."""

import pickle

import numpy as np
import pytest

from tgsr_tpu.cli.eval_rank import load_vocab as jload_vocab
from tgsr_tpu.data import tokenizer as jtok
from tgsr_tpu_torch.cli.eval_rank import load_vocab
from tgsr_tpu_torch.data import tokenizer as ttok

CAPTIONS = [
    "The woman has blond hair and a big nose.",
    "He is smiling, wearing a RED hat; his eyes are Brown!",
    "café  naïve  straße 42 x_y",
    "This  person has high cheekbones­ and an oval face.",
    "",
    "a an the of in on",
]


@pytest.mark.parametrize("cap", CAPTIONS)
@pytest.mark.parametrize("no_stopwords, only_color", [(False, False), (True, False),
                                                     (False, True), (True, True)])
def test_tokenize_caption_matches_jax(cap, no_stopwords, only_color):
    assert ttok.tokenize_caption(cap, no_stopwords, only_color) == jtok.tokenize_caption(
        cap, no_stopwords, only_color)


def test_word_lists_match_jax():
    assert ttok.COLOR_WORDS == jtok.COLOR_WORDS
    assert ttok._stopwords() == jtok._stopwords() and len(ttok._stopwords()) == 49


def test_build_dictionary_and_encode_match_jax():
    train = [ttok.tokenize_caption(c) for c in CAPTIONS[:3]]
    test = [ttok.tokenize_caption(c) for c in CAPTIONS[3:]]
    tr, te, vocab = ttok.build_dictionary(train, test)
    jtr, jte, jvocab = jtok.build_dictionary(train, test)
    assert (tr, te) == (jtr, jte)
    assert vocab.ixtoword == jvocab.ixtoword and vocab.wordtoix == jvocab.wordtoix
    for words_num in (4, 18):
        for seed in range(3):
            toks, lens = ttok.encode_batch(tr + te, words_num, np.random.default_rng(seed))
            jtoks, jlens = jtok.encode_batch(jtr + jte, words_num, np.random.default_rng(seed))
            np.testing.assert_array_equal(toks, jtoks)
            np.testing.assert_array_equal(lens, jlens)
            assert toks.dtype == jtoks.dtype and lens.dtype == jlens.dtype
    ids = list(range(1, 30))
    got = ttok.encode_caption(ids, 18, np.random.default_rng(7))
    want = jtok.encode_caption(ids, 18, np.random.default_rng(7))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 18 and list(got[0]) == sorted(got[0])
    assert ttok.encode_caption([], 5)[1] == jtok.encode_caption([], 5)[1] == 1


@pytest.mark.parametrize("layout", ["testset", "captions", "swapped"])
def test_load_vocab_matches_jax(tmp_path, layout):
    ixtoword = {0: "<end>", 1: "smiling", 2: "woman", 3: "hair"}
    wordtoix = {w: i for i, w in ixtoword.items()}
    obj = {"testset": [[[1, 2]], ixtoword, wordtoix],
           "captions": [[[1]], [[2, 3]], ixtoword, wordtoix],
           "swapped": [[[1, 2]], wordtoix, ixtoword]}[layout]
    path = tmp_path / "v.pickle"
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    got, want = load_vocab(str(path)), jload_vocab(str(path))
    assert got.ixtoword == want.ixtoword == ixtoword
    assert got.wordtoix == want.wordtoix == wordtoix
    with open(path, "wb") as f:
        pickle.dump([[1], {0: "<end>"}], f)
    with pytest.raises(ValueError):
        load_vocab(str(path))
