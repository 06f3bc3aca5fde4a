"""DAMSM retrieval ranking over generated SR results (counterpart of
tgsr_tpu/cli/eval_rank.py). Only `load_vocab` is ported so far, which the
serving CLI shares; the ranking itself needs the image encoder."""

from __future__ import annotations

import pickle

from tgsr_tpu_torch.data.tokenizer import Vocab


def load_vocab(path: str) -> Vocab:
    """Vocab from either pickle layout: [caps, ixtoword, wordtoix(, ...)]
    (testset.pickle) or [train, test, ixtoword, wordtoix] (captions.pickle).
    The file is unpickled: load only pickles of the dataset's own making."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    dicts = [o for o in obj if isinstance(o, dict)]
    if len(dicts) < 2:
        raise ValueError(f"no (ixtoword, wordtoix) dicts in {path}")
    ixtoword, wordtoix = dicts[0], dicts[1]
    if ixtoword and not isinstance(next(iter(ixtoword)), int):
        ixtoword, wordtoix = wordtoix, ixtoword
    return Vocab(ixtoword={int(k): v for k, v in ixtoword.items()}, wordtoix=wordtoix)
