"""Torch export entry point: msgpack snapshots -> reference-loadable `.pth`
files (counterpart of tgsr_tpu/cli/export_torch.py, with its flags and file
names, over checkpoints/export_torch.py).

Weights trained by `cli.train_gan` / `cli.pretrain_damsm` (flax trees in
msgpack) become state dicts the reference's torch modules, and the port's,
load with strict=True under the reference's names (netG / netGH pairing,
trainer_objective.py:91-93; text_encoder / image_encoder pairing,
pretrain_DAMSM.py:177-179). Each file keeps its snapshot's name with a
`.pth` suffix.

Usage:
  python -m tgsr_tpu_torch.cli.export_torch --cfg train_faceSR_S8.yml \\
      --netg o/Model/netG_it500.msgpack --out exported/
  python -m tgsr_tpu_torch.cli.export_torch \\
      --text_encoder o/<run>/Model/text_encoder5.msgpack --out exported/
"""

from __future__ import annotations

import argparse
import os
from typing import List


def pth_name(msgpack_path: str) -> str:
    """netG_it500.msgpack -> netG_it500.pth."""
    return os.path.splitext(os.path.basename(msgpack_path))[0] + ".pth"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Export msgpack snapshots to reference .pth checkpoints")
    parser.add_argument("--cfg", dest="cfg_file", default="",
                        help="training/eval YAML (required with --netg: selects the x8/x16 "
                             "family via TREE.BRANCH_NUM and the weight map via EVAL.WEIGHTMAP)")
    parser.add_argument("--netg", default="",
                        help="netG_it*.msgpack (the paired netGH_it* file is resolved "
                             "alongside, or pass --netgh)")
    parser.add_argument("--netgh", default="")
    parser.add_argument("--text_encoder", default="",
                        help="text_encoder<N>.msgpack (the paired image_encoder<N> file "
                             "exports too when present)")
    parser.add_argument("--out", required=True, help="output directory")
    return parser


def main(argv=None) -> List[str]:
    args = build_parser().parse_args(argv)
    if not (args.netg or args.text_encoder):
        raise SystemExit("pass --netg and/or --text_encoder")

    import torch

    from tgsr_tpu_torch.checkpoints.export_torch import export_cnn_encoder, export_netgh
    from tgsr_tpu_torch.checkpoints.from_jax import netg_state_dict, text_state_dict
    from tgsr_tpu_torch.checkpoints.msgpack_io import load_variables
    from tgsr_tpu_torch.checkpoints.reference import paired_path

    os.makedirs(args.out, exist_ok=True)
    written = []
    if args.netg:
        if not args.cfg_file:
            raise SystemExit("--netg needs --cfg to select the x8/x16 family "
                             "(TREE.BRANCH_NUM)")
        from tgsr_tpu_torch.config import config_from_file

        # only TREE.BRANCH_NUM and EVAL.WEIGHTMAP are read: any family exports,
        # served by the port or not (a weight map's a1..a4 included)
        cfg = config_from_file(args.cfg_file, check=lambda c: c)
        netgh_path = args.netgh or paired_path(args.netg, "netG", "netGH")
        pairs = ((netg_state_dict(load_variables(args.netg)), args.netg),
                 (export_netgh(load_variables(netgh_path), weightmap=cfg.EVAL.WEIGHTMAP),
                  netgh_path))
        for sd, src in pairs:
            dst = os.path.join(args.out, pth_name(src))
            torch.save(sd, dst)
            written.append(dst)
    if args.text_encoder:
        dst = os.path.join(args.out, pth_name(args.text_encoder))
        torch.save(text_state_dict(load_variables(args.text_encoder)), dst)
        written.append(dst)
        img_path = paired_path(args.text_encoder, "text_encoder", "image_encoder")
        if os.path.exists(img_path):
            iv = load_variables(img_path)
            if "inception" in iv["params"]:
                dst = os.path.join(args.out, pth_name(img_path))
                torch.save(export_cnn_encoder(iv), dst)
                written.append(dst)
            else:
                # --simple-cnn snapshots have no reference torch module to
                # export to; the text encoder still exports
                print(f"skipping {img_path}: SimpleCNNEncoder snapshot has no reference "
                      "torch counterpart")
    for p in written:
        print(f"exported {p}")
    return written


if __name__ == "__main__":
    main()
