"""DAMSM retrieval ranking over generated SR results (counterpart of
tgsr_tpu/cli/eval_rank.py).

Embeds the images with the DAMSM image encoder and the captions with the
text encoder, ranks every caption against every image by the DAMSM word-
and sentence-level similarities (`engine.evaluator.rank_r_precision`) and
prints R@1 and R@5 as one JSON line (R@k under the k used, capped at n).

  python -m tgsr_tpu_torch.cli.eval_rank --data_dir <dir with testset.txt> \\
      --image_dir <dir of SR PNGs> --vocab_pickle <captions pickle> \\
      [--dataset face] [--net_e text_encoder.msgpack|.pth] \\
      [--image_encoder image_encoder.msgpack|.pth] [--simple-cnn] [--device cpu]

JAX's flags, defaults and JSON line, plus `--device` (default "cuda").
Without encoder files the encoders run from a seeded init (torch's
generator from --seed, not JAX's PRNG), and the line's `seeded_encoders`
and a warning say so: the ranks are then a smoke test, not an evaluation.
The tail batch is padded with its last example to --batch and the padding
dropped.
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np
import torch

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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="DAMSM R-precision over generated SR results")
    parser.add_argument("--data_dir", required=True, help="directory holding --txt")
    parser.add_argument("--image_dir", required=True,
                        help="directory of generated images named per --txt")
    parser.add_argument("--txt", default="testset.txt")
    parser.add_argument("--dataset", default="face",
                        help="'face' = attr-table caption format, anything else = "
                             "'name|caption' lines")
    parser.add_argument("--vocab_pickle", required=True)
    parser.add_argument("--net_e", default="",
                        help="text encoder: .msgpack (flax tree) or .pth (torch)")
    parser.add_argument("--image_encoder", default="",
                        help="image encoder: .msgpack, a reference image_encoder .pth, or "
                             "torchvision inception .pth (heads stay init)")
    parser.add_argument("--simple-cnn", action="store_true")
    parser.add_argument("--imsize", type=int, default=256)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seed", type=int, default=100)
    parser.add_argument("--out", default="", help="optional JSON out path")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the card) or cpu")
    return parser


def load_encoders(args, cfg, n_words: int, device):
    """(text encoder, image encoder, the names of those left at the seeded
    init) as the flags ask, in eval mode on `device`."""
    from tgsr_tpu_torch.checkpoints.from_jax import (seeded_cnn_encoder_state_dict,
                                                     seeded_text_state_dict)
    from tgsr_tpu_torch.checkpoints.reference import load_image_encoder, load_text_encoder
    from tgsr_tpu_torch.models.image_encoder import make_image_encoder
    from tgsr_tpu_torch.models.text_encoder import TextEncoder

    nef = cfg.TEXT.EMBEDDING_DIM
    gen = torch.Generator().manual_seed(args.seed)
    text_enc = TextEncoder(n_words, 300, nef)
    text_sd = seeded_text_state_dict(cfg, n_words, gen)
    cnn_enc = make_image_encoder(args.simple_cnn, nef)
    cnn_sd = seeded_cnn_encoder_state_dict(args.simple_cnn, nef, gen)
    seeded = []
    if args.net_e:
        text_sd = load_text_encoder(args.net_e)
    else:
        seeded.append("text")
    if args.image_encoder:
        got = load_image_encoder(args.image_encoder)
        unknown = set(got) - set(cnn_sd)
        if unknown:
            raise SystemExit(f"--image_encoder {args.image_encoder} is not a "
                             f"{type(cnn_enc).__name__} ({len(unknown)} foreign entries); "
                             f"{'drop' if args.simple_cnn else 'pass'} --simple-cnn to match")
        cnn_sd = {**cnn_sd, **got}
    else:
        seeded.append("image")
    text_enc.load_state_dict(text_sd, strict=True)
    cnn_enc.load_state_dict(cnn_sd, strict=True)
    return text_enc.to(device).eval(), cnn_enc.to(device).eval(), seeded


@torch.no_grad()
def embed_all(ds, text_enc, cnn_enc, batch: int, device):
    """(region features, codes, word embeddings, sentences, lengths) of every
    example of `ds`, in batches of `batch` (the tail padded with its last
    example, the padding dropped), on `device`, TF32 off."""
    from tgsr_tpu_torch.engine.precision import float32_math
    from tgsr_tpu_torch.ops.image import normalize_uint8

    out = [[] for _ in range(5)]
    n = len(ds)
    for lo in range(0, n, batch):
        idx = list(range(lo, min(lo + batch, n)))
        ex = [ds[i] for i in idx + [idx[-1]] * (batch - len(idx))]
        imgs = normalize_uint8(torch.from_numpy(np.stack([e.hr for e in ex])).to(device))
        caps = torch.from_numpy(np.stack([e.tokens for e in ex])).long().to(device)
        lens = torch.tensor([e.length for e in ex], dtype=torch.long, device=device)
        with float32_math():
            embs = (*cnn_enc(imgs), *text_enc(caps, lens), lens)
        for acc, x in zip(out, embs):
            acc.append(x[:len(idx)])
    return tuple(torch.cat(x) for x in out)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tgsr_tpu_torch.config import Config
    from tgsr_tpu_torch.data.datasets import TextSRGTDataset
    from tgsr_tpu_torch.engine.evaluator import rank_r_precision
    from tgsr_tpu_torch.engine.inference import resolve_device

    device = resolve_device(args.device)
    cfg = Config()
    vocab = load_vocab(args.vocab_pickle)
    ds = TextSRGTDataset(vocab, args.data_dir, args.image_dir, txt=args.txt,
                         dataset=args.dataset, words_num=cfg.TEXT.WORDS_NUM, imsize=args.imsize)
    n = len(ds)
    if n == 0:
        raise SystemExit(f"no entries in {args.data_dir}/{args.txt}")
    print(f"{n} (image, caption) pairs, vocab {vocab.n_words}")
    text_enc, cnn_enc, seeded = load_encoders(args, cfg, vocab.n_words, device)
    if seeded:
        print(f"WARNING: {'/'.join(seeded)} encoder(s) at seeded random init — ranks are a "
              "pipeline smoke, not an evaluation")
    feat, code, words, sent, lens = embed_all(ds, text_enc, cnn_enc, args.batch, device)

    s = cfg.TRAIN.SMOOTH
    gammas = (s.GAMMA1, s.GAMMA2, s.GAMMA3)
    res = {"n": n, "seeded_encoders": seeded}
    for k in (1, 5):
        # R@k under the k actually used (capped at n): 1 < n < 5 gives
        # word_r@{n}, n == 1 a single word_r@1
        kk = min(k, n)
        if f"word_r@{kk}" not in res:
            r = rank_r_precision(feat, code, words, sent, lens, gammas, top_k=kk)
            res[f"word_r@{kk}"] = r[f"word_r@{kk}"]
            res[f"sent_r@{kk}"] = r[f"sent_r@{kk}"]
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
