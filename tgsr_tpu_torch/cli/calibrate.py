"""int8 calibration entry point (counterpart of tgsr_tpu/cli/calibrate.py):
run the float32 pipeline over one canonical batch and augmented views
(random crops, flips, noise) of the eval set, take the pointwise max of the
recorded per-conv absmax scales (`merge_scales`), gate the int8 pipeline's
fidelity against the float32 output, and write the scales JSON that
`SRPipeline(quant_scales=...)`, `cli.test --scales`, `cli.serve --scales`
and `save_artifact` read.

  python -m tgsr_tpu_torch.cli.calibrate --cfg configs/eval_faceSR_attn2.yml \\
      --data_dir <face data dir> --ckpt_dir <dir of netG_epoch_7.pth> \\
      --out face_scales.json [--batches 2] [--margin 1.1] [--no-heads] [--device cpu]

The JAX package's flags, defaults and messages, plus `--device` (default
"cuda"). The JSON's '_meta' carries the weights' fingerprint, the JAX
package's fingerprint of the same weights, so that each package's
`check_scales` accepts the other's file; a failing gate writes nothing.
The augmented views crop, flip and resize through data/codec.py, bit for
bit PIL's, with the JAX package's rng draws in its order.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def augmented_lr_batch(hr_uint8: np.ndarray, base_size: int, rng,
                       noise: float = 0.02) -> np.ndarray:
    """A varied-view LR batch from HR uint8 [B, H, W, 3]: per image a random
    crop of 0.6-1.0 of the short side (PIL's crop: zeros past the edge), a
    coin-flip mirror, PIL's BICUBIC resize to base_size and gaussian noise,
    normalised to [-1, 1] and clipped. float32 [B, base, base, 3]."""
    from tgsr_tpu_torch.data.codec import resize_pil

    b = hr_uint8.shape[0]
    lr = np.empty((b, base_size, base_size, 3), np.float32)
    for i in range(b):
        img = np.asarray(hr_uint8[i])
        h, w = img.shape[:2]
        cw = ch = max(base_size, int(min(w, h) * rng.uniform(0.6, 1.0)))
        left = int(rng.integers(0, max(w - cw, 0) + 1))
        top = int(rng.integers(0, max(h - ch, 0) + 1))
        crop = np.zeros((ch, cw, 3), np.uint8)
        part = img[top:top + ch, left:left + cw]
        crop[:part.shape[0], :part.shape[1]] = part
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        a = resize_pil(np.ascontiguousarray(crop), (base_size, base_size),
                       "bicubic").astype(np.float32) / 127.5 - 1.0
        lr[i] = np.clip(a + rng.normal(0, noise, a.shape), -1.0, 1.0)
    return lr


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Calibrate int8 serving scales for a TGSR checkpoint (PyTorch/CUDA)")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--data_dir", default="")
    parser.add_argument("--ckpt_dir", default="",
                        help="directory holding netG/netGH files when the YAML's "
                             "TRAIN.NET_G path doesn't exist")
    parser.add_argument("--seeded-text", action="store_true",
                        help="force the seeded-init text encoder (parity protocol) instead of "
                             "cfg NET_E / the shipped trained NET_E")
    parser.add_argument("--text_encoder", default="",
                        help="trained text-encoder weights (.pth/.msgpack); default = the "
                             "seeded-init convention")
    parser.add_argument("--out", required=True, help="where to write the scales JSON")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--batches", type=int, default=2,
                        help="total calibration batches: 1 canonical + N-1 augmented "
                             "(crops/flips/noise)")
    parser.add_argument("--margin", type=float, default=1.1,
                        help="headroom factor on recorded absmax scales")
    parser.add_argument("--gate_db", type=float, default=35.0,
                        help="minimum int8-vs-f32 output PSNR; the JSON is only written when "
                             "the gate passes (0 disables)")
    parser.add_argument("--no-heads", dest="heads", action="store_false",
                        help="keep the 3-channel image heads in bf16 (higher fidelity)")
    parser.add_argument("--seed", type=int, default=0,
                        help="augmentation rng seed (views only)")
    parser.add_argument("--text_seed", type=int, default=100,
                        help="seeded-init text encoder seed when no --text_encoder is given; "
                             "must match the serving pipeline's (cli.test --manualSeed, "
                             "default 100), or the recorded scales describe activations "
                             "serving never sees")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cpu runs every kernel site's plain version)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    from tgsr_tpu_torch.checkpoints.shipped import resolve_net_e
    from tgsr_tpu_torch.cli.test import (build_example_dataset, degrade, load_config,
                                         resolve_netg_path)
    from tgsr_tpu_torch.data.pipeline import BatchLoader
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.engine.quant import SCALES_META_KEY, drop_head_scales, merge_scales

    args = parse_args(argv)
    cfg = load_config(args.cfg_file, args.data_dir)
    rng = np.random.default_rng(args.seed)

    ds = build_example_dataset(cfg)
    netg_path = resolve_netg_path(cfg, args.ckpt_dir)
    # calibration runs the float32 pipeline (the absmaxes must describe the
    # unquantized activations) with the text encoder the serving CLIs
    # resolve (the word embeddings feed the attention path)
    net_e_path, net_e_src = resolve_net_e(cfg, args.text_encoder, ds.n_words,
                                          seeded=args.seeded_text)
    print(f"text encoder: {net_e_src}")
    pipe = SRPipeline.from_reference_checkpoints(
        cfg, ds.n_words, netg_path, text_encoder_path=net_e_path, device=args.device,
        compute_dtype=torch.float32, text_seed=args.text_seed)

    loader = BatchLoader(ds, min(args.batch, len(ds)), shuffle=False, drop_last=False,
                         deterministic_captions=True)
    # each view covers other images when the dataset has them (cycling when
    # it does not); the canonical degrade only on the first
    batches = []
    for b in loader.epoch(0):
        batches.append(b)
        if len(batches) >= max(args.batches, 1):
            break
    batch = batches[0]
    base = cfg.TREE.BASE_SIZE
    lr0 = degrade(batch["hr"], base, pipe.device).cpu().numpy()
    views = [(lr0, batch["captions"], batch["cap_lens"])]
    for i in range(1, max(args.batches, 1)):
        src = batches[i % len(batches)]
        views.append((augmented_lr_batch(np.asarray(src["hr"]), base, rng),
                      src["captions"], src["cap_lens"]))

    per_view = [pipe.calibrate_quant(lr, caps, lens, margin=args.margin)
                for lr, caps, lens in views]
    scales = {g: merge_scales(*(v[g] for v in per_view)) for g in per_view[0]}
    if not args.heads:
        scales = drop_head_scales(scales)
    n = sum(len(v) for v in scales.values())
    # only keys the canonical view recorded: a conv seen in augmented views
    # alone has no canonical baseline
    grown = sum(1 for g in scales for k in scales[g]
                if len(per_view) > 1 and k in per_view[0][g]
                and scales[g][k] > per_view[0][g][k] * 1.02)
    print(f"calibrated {n} conv scales over {len(views)} batches ({grown} grew >2% beyond "
          "the canonical batch)")

    # fidelity gate: int8 with bfloat16 compute, as served, against float32
    pipe_i8 = SRPipeline(cfg, ds.n_words, *pipe.state_dicts, a=pipe.a, device=args.device,
                         compute_dtype=torch.bfloat16, quant_scales=scales)
    nfid = min(4, lr0.shape[0])
    fid = (lr0[:nfid], batch["captions"][:nfid], batch["cap_lens"][:nfid])
    out_f32 = pipe(*fid)["sr"].float().cpu().numpy()
    out_i8 = pipe_i8(*fid)["sr"].float().cpu().numpy()
    rmse = float(np.sqrt(np.mean((out_f32 - out_i8) ** 2))) * 127.5
    psnr = 20 * np.log10(255.0 / max(rmse, 1e-9))
    ok = psnr >= args.gate_db
    print(f"int8 vs f32: rmse {rmse:.3f}/255, psnr {psnr:.1f} dB "
          f"({'PASS' if ok else 'FAIL'} >= {args.gate_db}; gate measured "
          "at bf16+int8 — conservative vs cli.test's default f32 serve)")
    if not ok:
        raise SystemExit(f"fidelity gate failed ({psnr:.1f} < {args.gate_db} dB): not "
                         f"writing {args.out}; widen --margin, try --no-heads, or lower "
                         "--gate_db if this fidelity is acceptable")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    # provenance: the scales are bound to the calibrated weights, so that a
    # load on other weights refuses them (check_scales)
    meta = {
        "weights_fingerprint": pipe.weights_fingerprint(),
        "checkpoint": os.path.basename(netg_path),
        "text_encoder": os.path.basename(net_e_path) if net_e_path else net_e_src,
        "calibration": f"{len(views)} views, margin {args.margin}",
        "gate_db": round(psnr, 2),
        "gate_protocol": "bf16+int8 vs f32 (conservative)",
    }
    with open(args.out, "w") as f:
        json.dump({**scales, SCALES_META_KEY: meta}, f, indent=1, sort_keys=True)
    print(f"saved {args.out} (serve with cli.test --scales / SRPipeline(quant_scales=...))")
    return {"scales": scales, "meta": meta, "views": views, "psnr": float(psnr)}


if __name__ == "__main__":
    main()
