"""Evaluation / inference entry point (counterpart of tgsr_tpu/cli/test.py,
the reference's test1.py with gen_exampleSRHL): x8 text-guided SR over an
example test set, writing `<key>_SR.png` and one attention grid per image.

  python -m tgsr_tpu_torch.cli.test --cfg configs/eval_faceSR_attn2.yml \\
      --data_dir <face data dir> --ckpt_dir <dir of netG_epoch_7.pth> \\
      --out_dir ./out [--batch 16] [--no-bf16] [--int8 | --scales s.json] \\
      [--metrics] [--arbitrary [--bucket 64]] [--save_artifact bundle/]
      [--device cpu]

The JAX package's flags, defaults and messages, plus `--device` (default
"cuda"; "cpu" runs every kernel site's plain version). The data directory
holds testset.pickle, or testset.txt to build it from (for the face set the
CelebA attribute table, whose vocabulary is the attribute names), and the
images under Img/changetxt_im1/ (PNG). Each batch is degraded on the device
(`ops.image.resize(normalize_uint8(hr), (BASE, BASE), "bilinear")`, the
antialiased bilinear of jax.image.resize) and runs the forward with the
attention maps (`SRPipeline.__call__`, return_attn); the grids are drawn on
the host (utils/visualize.py). `--int8` calibrates on batch 0 through a
float32 twin of the pipeline and then serves int8 in the compute dtype,
bfloat16 or (`--no-bf16`) float32; `--scales` serves a calibrated JSON
without calibrating. `--arbitrary` runs each image at its own size through
`sr_arbitrary`. `main` returns a summary of the run (counts and host
seconds) for scripts and tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import pprint
import shutil
import tempfile
import time

import numpy as np
import torch


def gen_example_pickle(data_dir: str, vocab, namein: str = "testset.txt",
                       namecp: str = "testset.pickle", dataset: str = "face",
                       no_stopwords: bool = False, only_color: bool = False) -> str:
    """gen_examplePickle: tokenize the example captions with the TRAIN
    vocabulary and cache [caption_ids, ixtoword, wordtoix] (pickle protocol
    2). For the face dataset the captions come from the CelebA attribute
    table (train rows, then test rows). An existing file is kept."""
    from tgsr_tpu_torch.data.datasets import TextFaceDataset
    from tgsr_tpu_torch.data.tokenizer import tokenize_caption

    out_path = os.path.join(data_dir, namecp)
    if os.path.exists(out_path):
        return out_path
    caps_ids = []
    src = os.path.join(data_dir, namein)
    if dataset == "face":
        with tempfile.TemporaryDirectory() as td:
            shutil.copy(src, os.path.join(td, "list_attr_celeba.txt"))
            caps_tr, _ = TextFaceDataset.load_attr_captions(td, True)
            caps_te, _ = TextFaceDataset.load_attr_captions(td, False)
        for toks in caps_tr + caps_te:
            caps_ids.append([vocab.wordtoix[w] for w in toks if w in vocab.wordtoix])
    else:
        with open(src) as f:
            names = [n for n in f.read().split("\n") if n]
        for name in names:
            with open(os.path.join(data_dir, f"{name}.txt")) as f:
                caps = [c for c in f.read().split("\n") if c]
            cnt = 0
            for cap in caps:
                toks = tokenize_caption(cap, no_stopwords, only_color)
                if not toks:
                    continue
                caps_ids.append([vocab.wordtoix[w] for w in toks if w in vocab.wordtoix])
                cnt += 1
                if cnt == 10:
                    break
    with open(out_path, "wb") as f:
        pickle.dump([caps_ids, vocab.ixtoword, vocab.wordtoix], f, protocol=2)
    return out_path


def build_example_dataset(cfg):
    """The example eval dataset of `cfg`: DATA_DIR's testset.pickle when
    present, else built from testset.txt with the train vocabulary as
    test1.py builds it (for the face dataset the vocabulary comes from the
    attribute table itself)."""
    from tgsr_tpu_torch.data.datasets import TextExampleSRDataset

    cap_pickle = os.path.join(cfg.DATA_DIR, "testset.pickle")
    if not os.path.exists(cap_pickle):
        src = os.path.join(cfg.DATA_DIR, "testset.txt")
        if not os.path.exists(src):
            raise SystemExit(f"{cap_pickle} not found and no testset.txt to build it from")
        if cfg.DATASET_NAME == "face":
            from tgsr_tpu_torch.data.datasets import TextFaceDataset
            from tgsr_tpu_torch.data.tokenizer import build_dictionary

            with tempfile.TemporaryDirectory() as td:
                shutil.copy(src, os.path.join(td, "list_attr_celeba.txt"))
                tr, _ = TextFaceDataset.load_attr_captions(td, True)
                te, _ = TextFaceDataset.load_attr_captions(td, False)
            _, _, vocab = build_dictionary(tr, te)
        else:
            from tgsr_tpu_torch.data.datasets import TextSRDataset

            vocab = TextSRDataset(cfg.DATA_DIR, split="train", words_num=cfg.TEXT.WORDS_NUM,
                                  embeddings_num=cfg.TEXT.CAPTIONS_PER_IMAGE).vocab
        cap_pickle = gen_example_pickle(cfg.DATA_DIR, vocab, dataset=cfg.DATASET_NAME,
                                        no_stopwords=cfg.EVAL.NO_STOPWORD,
                                        only_color=cfg.EVAL.ONLY_COLOR)
        print("generated", cap_pickle)
    return TextExampleSRDataset(cfg.DATA_DIR, cap_pickle, words_num=cfg.TEXT.WORDS_NUM,
                                imsize=cfg.imsize)


def resolve_netg_path(cfg, ckpt_dir: str) -> str:
    """The checkpoint of the eval and calibration CLIs: the YAML's
    TRAIN.NET_G, else `ckpt_dir`'s netG_epoch_7.pth."""
    netg_path = cfg.TRAIN.NET_G
    if not os.path.exists(netg_path) and ckpt_dir:
        netg_path = os.path.join(ckpt_dir, "netG_epoch_7.pth")
    if not os.path.exists(netg_path):
        raise SystemExit(f"netG checkpoint not found: {netg_path}")
    return netg_path


def load_config(cfg_file: str, data_dir: str = ""):
    """The YAML config, with DATA_DIR replaced by `data_dir` when given."""
    from tgsr_tpu_torch.config import config_from_file

    cfg = config_from_file(cfg_file)
    return dataclasses.replace(cfg, DATA_DIR=data_dir) if data_dir else cfg


@torch.inference_mode()
def degrade(hr_uint8, base_size: int, device) -> torch.Tensor:
    """HR uint8 [B, H, W, 3] -> the LR input on `device`, float32 [-1, 1]
    [B, base, base, 3]: jax.image.resize's antialiased bilinear."""
    from tgsr_tpu_torch.ops.image import normalize_uint8, resize

    hr = torch.as_tensor(np.asarray(hr_uint8), device=device)
    return resize(normalize_uint8(hr), (base_size, base_size), "bilinear")


def write_png(path: str, rgb: np.ndarray) -> None:
    from tgsr_tpu_torch.data.codec import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(rgb)))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="TGSR eval (PyTorch/CUDA)")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--data_dir", default="")
    parser.add_argument("--out_dir", default="./output_sr")
    parser.add_argument("--ckpt_dir", default="",
                        help="directory holding netG/netGH .pth files (cfg.TRAIN.NET_G may "
                             "instead point at a .pth OR a netG .msgpack snapshot; netGH "
                             "paired by name either way)")
    parser.add_argument("--text_encoder", default="",
                        help="trained text-encoder weights (.pth or .msgpack)")
    parser.add_argument("--seeded-text", action="store_true",
                        help="force the seeded-init text encoder (the parity protocol) "
                             "instead of resolving cfg NET_E / the shipped trained NET_E")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--manualSeed", type=int, default=100)
    parser.add_argument("--savefile", default="testset")
    parser.add_argument("--metrics", action="store_true",
                        help="also run the batched eval harness (on-device degrade -> SR -> "
                             "Y-PSNR/SSIM) and print JSON")
    parser.add_argument("--arbitrary", action="store_true",
                        help="native-geometry eval: each image keeps its own size, cropped to "
                             "scale multiples")
    parser.add_argument("--bucket", type=int, default=0,
                        help="with --arbitrary: pad LR sizes up to multiples of BUCKET "
                             "(0 = exact native shapes)")
    parser.add_argument("--save_artifact", default="",
                        help="after building the (optionally int8) pipeline, bundle it + the "
                             "vocab into this deployment dir (SRPipeline.save_artifact; serve "
                             "it with cli.serve --artifact)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 quantized serving (engine/quant.py): calibrates activation "
                             "scales on the first batch, then runs every generator conv in "
                             "int8")
    parser.add_argument("--scales", default="",
                        help="precalibrated int8 scales JSON (cli.calibrate output); implies "
                             "int8 serving without the batch-0 calibration pass")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cpu runs every kernel site's plain version)")
    args = parser.parse_args(argv)
    if args.scales and args.int8:
        parser.error("--scales already selects int8; drop --int8 (it would recalibrate on "
                     "batch 0)")
    return args


def main(argv=None) -> dict:
    from tgsr_tpu_torch.checkpoints.shipped import resolve_net_e
    from tgsr_tpu_torch.data.datasets import load_arbitrary_eval_image
    from tgsr_tpu_torch.data.pipeline import BatchLoader
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.ops.image import bucket_shape
    from tgsr_tpu_torch.utils.visualize import build_super_images_all

    args = parse_args(argv)
    t_start = time.perf_counter()
    cfg = load_config(args.cfg_file, args.data_dir)
    pprint.pprint(cfg)
    np.random.seed(args.manualSeed)

    ds = build_example_dataset(cfg)
    netg_path = resolve_netg_path(cfg, args.ckpt_dir)
    # NET_E: flag > cfg NET_E > shipped trained NET_E > seeded
    net_e_path, net_e_src = resolve_net_e(cfg, args.text_encoder, ds.n_words,
                                          seeded=args.seeded_text)
    print(f"text encoder: {net_e_src}")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    pipe = SRPipeline.from_reference_checkpoints(
        cfg, ds.n_words, netg_path, text_encoder_path=net_e_path, device=args.device,
        compute_dtype=dtype, return_attn=True, text_seed=args.manualSeed)

    out_dir = os.path.join(args.out_dir, args.savefile)
    att_dir = os.path.join(out_dir, "att")
    os.makedirs(att_dir, exist_ok=True)
    loader = BatchLoader(ds, min(args.batch, len(ds)), shuffle=False, drop_last=False,
                         deterministic_captions=True)
    base = cfg.TREE.BASE_SIZE
    summary = {"out_dir": out_dir, "images": 0, "grids": 0, "grid_seconds": 0.0,
               "int8": bool(args.int8 or args.scales), "compute_dtype": str(dtype)[6:],
               "metrics": None}

    if args.int8 or args.scales:
        if args.scales:
            with open(args.scales) as f:
                scales = json.load(f)
            src = args.scales
        else:
            # calibrate on the first batch; the recorded absmaxes describe
            # the unquantized activations (cli.calibrate's contract), so the
            # pass runs on a float32 twin of the pipeline
            cal = next(iter(loader.epoch(0)))
            cal_lr = degrade(cal["hr"], base, pipe.device)
            pipe_f32 = SRPipeline(cfg, ds.n_words, *pipe.state_dicts, a=pipe.a,
                                  device=args.device, compute_dtype=torch.float32)
            scales = pipe_f32.calibrate_quant(cal_lr, cal["captions"], cal["cap_lens"])
            del pipe_f32
            src = "batch 0 (f32 pass)"
        pipe = SRPipeline(cfg, ds.n_words, *pipe.state_dicts, a=pipe.a, device=args.device,
                          compute_dtype=dtype, return_attn=True, quant_scales=scales)
        print(f"int8 serving: {len(scales['netg'])}+{len(scales['netgh'])} conv scales "
              f"from {src}")

    if args.save_artifact:
        # the bundle drops return_attn: this CLI computes attention for the
        # grids, serving must not pay for it
        pipe.save_artifact(args.save_artifact, vocab=ds.vocab, return_attn=False)
        print(f"serving artifact -> {args.save_artifact}")

    n_done = 0
    if args.arbitrary:
        shapes = set()
        for i in range(min(len(ds), cfg.EVAL.TEXT_BATCH_NUM)):
            path = os.path.join(ds.data_dir, ds.image_subdir, ds.filenames[i])
            if not os.path.exists(path):
                path = os.path.join(ds.data_dir, ds.filenames[i])
            if not os.path.exists(path):
                continue  # evaluate whatever images are present
            lr, _ = load_arbitrary_eval_image(path, cfg.scale)
            toks, length = ds.get_caption(i)
            sr = pipe.sr_arbitrary(lr, toks[None].astype(np.int32),
                                   np.asarray([length], np.int32), bucket=args.bucket or None)
            h, w = lr.shape[1:3]
            shapes.add(bucket_shape(h, w, 1, args.bucket) if args.bucket else (h, w))
            stem = os.path.splitext(ds.filenames[i])[0]
            write_png(os.path.join(out_dir, f"{stem}_SR.png"), sr[0])
            n_done += 1
        print(f"saved {n_done} native-geometry SR images to {out_dir} ({len(shapes)} distinct "
              "LR shapes run)")
        summary.update(images=n_done, lr_shapes=len(shapes),
                       seconds=time.perf_counter() - t_start)
        return summary

    for batch in loader.epoch(0):
        lr = degrade(batch["hr"], base, pipe.device)
        out = pipe(lr, batch["captions"], batch["cap_lens"])
        sr8 = to_uint8(out["sr"]).cpu().numpy()
        attn0 = out["attn"][0].cpu().numpy()
        for j, key in enumerate(batch["keys"]):
            stem = os.path.splitext(key)[0]
            write_png(os.path.join(out_dir, f"{stem}_SR.png"), sr8[j])
            # vis_size 256, build_super_imagesall's default; the layout is
            # only self-consistent at 256
            t0 = time.perf_counter()
            grid, _ = build_super_images_all(sr8[j:j + 1], batch["captions"][j:j + 1],
                                             [batch["cap_lens"][j]], ds.vocab.ixtoword,
                                             attn0[j:j + 1])
            summary["grid_seconds"] += time.perf_counter() - t0
            if grid is not None:
                write_png(os.path.join(att_dir, f"{stem}.png"), grid)
                summary["grids"] += 1
            n_done += 1
        if n_done >= cfg.EVAL.TEXT_BATCH_NUM:
            break
    print(f"saved {n_done} SR images to {out_dir}")
    summary.update(images=n_done, seconds=time.perf_counter() - t_start)

    if args.metrics:
        from tgsr_tpu_torch.engine.evaluator import evaluate_sr

        mloader = BatchLoader(ds, min(args.batch, len(ds)), shuffle=False, drop_last=False,
                              deterministic_captions=True)
        m = evaluate_sr(pipe, mloader.epoch(0), max_images=cfg.EVAL.TEXT_BATCH_NUM)
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in m.items()}))
        summary["metrics"] = m
    return summary


if __name__ == "__main__":
    main()
