"""Caption tokenization and vocabulary (counterpart of
tgsr_tpu/data/tokenizer.py): RegexpTokenizer(r'\\w+') + lowercase + ASCII
filter, the insertion-order dictionary with '<end>' = 0, caption encoding
padded with 0 or cut to a sorted random subsample, and the stopword- and
colour-word-filtered caption variants.

The stopwords are the JAX package's built-in list of 49 words, which it
falls back to when nltk's corpus is absent; the port does not read nltk.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WORD_RE = re.compile(r"\w+")

# the common colour terms of the reference's colour filter
COLOR_WORDS = frozenset(
    "red orange yellow green blue purple pink brown black white grey gray "
    "golden gold silver beige tan cream ivory maroon navy teal cyan magenta "
    "violet indigo turquoise olive crimson scarlet azure".split()
)

_STOPWORDS = frozenset(
    "a an the and or but if then this that these those is are was "
    "were be been being have has had do does did of in on at to "
    "from with for by as it its his her their our your my i you he "
    "she they we".split()
)


def _stopwords() -> frozenset:
    return _STOPWORDS


def tokenize_caption(cap: str, no_stopwords: bool = False,
                     only_color: bool = False) -> List[str]:
    """RegexpTokenizer(r'\\w+') + lower + ASCII filter, optionally without
    stopwords or with colour words only."""
    cap = cap.replace("��", " ")
    tokens = _WORD_RE.findall(cap.lower())
    out = []
    sw = _stopwords() if no_stopwords else None
    for t in tokens:
        t = t.encode("ascii", "ignore").decode("ascii")
        if not t:
            continue
        if no_stopwords and t in sw:
            continue
        if only_color and t not in COLOR_WORDS:
            continue
        out.append(t)
    return out


@dataclass
class Vocab:
    ixtoword: Dict[int, str]
    wordtoix: Dict[str, int]

    @property
    def n_words(self) -> int:
        return len(self.ixtoword)

    def encode_tokens(self, tokens: Sequence[str]) -> List[int]:
        return [self.wordtoix[w] for w in tokens if w in self.wordtoix]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.ixtoword[int(i)] for i in ids if int(i) in self.ixtoword]


def build_dictionary(train_captions: List[List[str]], test_captions: List[List[str]]
                     ) -> Tuple[List[List[int]], List[List[int]], Vocab]:
    """Insertion-order vocabulary over train + test with '<end>' = 0 (every
    word kept); returns (train ids, test ids, vocab)."""
    word_counts: Dict[str, float] = defaultdict(float)
    for sent in train_captions + test_captions:
        for w in sent:
            word_counts[w] += 1
    ixtoword = {0: "<end>"}
    wordtoix = {"<end>": 0}
    for ix, w in enumerate(word_counts, start=1):
        wordtoix[w] = ix
        ixtoword[ix] = w
    vocab = Vocab(ixtoword, wordtoix)
    return ([vocab.encode_tokens(t) for t in train_captions],
            [vocab.encode_tokens(t) for t in test_captions], vocab)


def encode_caption(sent_ids: Sequence[int], words_num: int,
                   rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, int]:
    """Pad to words_num with 0 ('<end>'); if longer, keep a random sorted
    subsample drawn from `rng` (a fresh default_rng when None). Returns
    ([words_num] int64, length), the length at least 1."""
    sent = np.asarray(sent_ids, np.int64)
    x = np.zeros((words_num,), np.int64)
    n = len(sent)
    if n <= words_num:
        x[:n] = sent
        return x, max(n, 1)
    rng = rng or np.random.default_rng()
    ix = np.sort(rng.permutation(n)[:words_num])
    x[:] = sent[ix]
    return x, words_num


def encode_batch(caption_ids: Sequence[Sequence[int]], words_num: int,
                 rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A batch of encoded captions -> (tokens [B, T] int32, lens [B] int32)."""
    toks = np.zeros((len(caption_ids), words_num), np.int32)
    lens = np.zeros((len(caption_ids),), np.int32)
    for i, c in enumerate(caption_ids):
        toks[i], lens[i] = encode_caption(c, words_num, rng)
    return toks, lens
