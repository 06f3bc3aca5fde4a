"""Export entry point: a deployment bundle or reference checkpoints -> an
exported serving program (counterpart of tgsr_tpu/cli/export_aot.py, over
engine/aot.py `export_serving`).

The output directory holds the whole forward with its weights
(`forward.pt2`, `torch.export`) and `meta.json`. A serving host runs it with
torch and the port's op registrations (`tgsr_tpu_torch.ops.library`), no
model code and no checkpoint: `python -m tgsr_tpu_torch.cli.serve --aot
<dir> --vocab_pickle <pickle>`.

Usage:
  python -m tgsr_tpu_torch.cli.export_aot --artifact bundle/ --out aot/ \\
      [--batch N] [--lr_size S] [--float] [--platforms cpu,cuda] [--device cpu]
  python -m tgsr_tpu_torch.cli.export_aot --cfg eval_faceSR_S8.yml \\
      --netg netG_epoch_7.pth --out aot/ [--int8] [--f32]

The program is traced on `--device` (default cuda: the card's program, in
the card's memory layout) and may be loaded on the device types
`--platforms` lists (default: `--device`'s).
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export an SR serving program (torch.export)")
    parser.add_argument("--artifact", default="",
                        help="SRPipeline.save_artifact bundle to export (carries config, "
                             "weights and int8 scales)")
    parser.add_argument("--cfg", dest="cfg_file", default="")
    parser.add_argument("--netg", default="",
                        help="reference netG_epoch_*.pth (netGH resolved alongside); "
                             "alternative to --artifact")
    parser.add_argument("--text_encoder", default="")
    parser.add_argument("--vocab_pickle", default="",
                        help="with --cfg/--netg: the text encoder's vocabulary size from this "
                             "pickle (default: the face testset's 41-token vocabulary)")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--batch", type=int, default=0,
                        help="pin the batch size (default: symbolic, one program serves any "
                             "batch size)")
    parser.add_argument("--lr_size", type=int, default=0,
                        help="LR spatial size (default cfg.TREE.BASE_SIZE)")
    parser.add_argument("--float", dest="float_out", action="store_true",
                        help="return float32 in [-1, 1] instead of the uint8 save-path "
                             "postprocess")
    parser.add_argument("--platforms", default="",
                        help="comma-separated device types the program may be loaded on "
                             "(cpu, cuda); default --device's")
    parser.add_argument("--int8", action="store_true",
                        help="with --cfg/--netg: the shipped int8 scales (face S8 for the x8 "
                             "family, x16 for the x16 one); bundles carry their own")
    parser.add_argument("--f32", action="store_true",
                        help="full float32 compute (default bfloat16 for --cfg/--netg; "
                             "bundles keep their own dtype)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the program is traced on (cpu: every kernel "
                             "site's plain version)")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from tgsr_tpu_torch.engine.aot import export_serving
    from tgsr_tpu_torch.engine.inference import SRPipeline

    if args.artifact:
        # cli.serve's override rules: --int8 requires bundled scales, --f32
        # forces full precision (no int8), the default keeps the bundle's own
        pipe, _ = SRPipeline.load_artifact(
            args.artifact, device=args.device,
            compute_dtype=torch.float32 if args.f32 else None,
            use_quant=True if args.int8 else False if args.f32 else None)
    else:
        if not (args.cfg_file and args.netg):
            raise SystemExit("pass --artifact OR --cfg + --netg")
        from tgsr_tpu_torch.config import config_from_file
        from tgsr_tpu_torch.engine.quant import face_s8_scales, x16_scales

        cfg = config_from_file(args.cfg_file)
        quant = None
        if args.int8:
            quant = face_s8_scales() if cfg.TREE.BRANCH_NUM == 4 else x16_scales()
        if args.vocab_pickle:
            from tgsr_tpu_torch.cli.eval_rank import load_vocab

            n_words = load_vocab(args.vocab_pickle).n_words
        else:
            # the face testset pickle's 41-token vocabulary, the only one the
            # shipped reference weights pair with
            n_words = 41
        pipe = SRPipeline.from_reference_checkpoints(
            cfg, n_words, args.netg, text_encoder_path=args.text_encoder or None,
            device=args.device, compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
            quant_scales=quant)

    import json
    import os

    out = export_serving(pipe, args.out, batch_size=args.batch or None,
                         lr_size=args.lr_size or None, uint8=not args.float_out,
                         platforms=[p for p in args.platforms.split(",") if p] or None)
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    print(f"exported {out}: batch={meta['batch']} lr={meta['lr_size']} "
          f"sr={meta['sr_size']} uint8={meta['uint8']} "
          f"platforms={meta['platforms']} quantized={meta['quantized']}", flush=True)
    return meta


if __name__ == "__main__":
    main()
