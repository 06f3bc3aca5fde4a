"""DAMSM pretraining entry point (counterpart of tgsr_tpu/cli/pretrain_damsm.py;
= pretrain_DAMSM.py): the text and image encoders trained together through
`engine/damsm_trainer.DAMSMTrainer`, with the per-epoch lr decay and Adam
reset, the text-gradient clip, snapshots and attention grids.

  python -m tgsr_tpu_torch.cli.pretrain_damsm --cfg <DAMSM yml> --data_dir <root> \\
      [--out_dir ../output] [--simple-cnn] [--bf16] [--inception_ckpt zoo.pth] \\
      [--resume_from <run>/Model/text_encoder<N>.msgpack] [--device cpu]
  torchrun --nproc_per_node N -m tgsr_tpu_torch.cli.pretrain_damsm ... --mesh Nx1

JAX's flags, defaults and messages, plus `--device` (default "cuda"; "cpu"
on request). A run writes `<out_dir>/<DATASET>_DAMSM_<time>/`:
`Model/text_encoder{epoch}.msgpack` and `image_encoder{epoch}.msgpack` (flax
trees through `checkpoints/io.save_variables`, byte for byte flax's
serializer, so JAX's `load_variables` reads them, and the port's GAN
trainer takes the image encoder with `--image_encoder`), `Image/
attention_maps{epoch}.png` (the words loss's attention over a validation
batch, `utils/visualize.build_super_images`) and `Log/metrics.jsonl` (and
`metrics.csv` with --csv). Ctrl-C or SIGTERM writes the state as epoch -1
and stops. `--resume_from text_encoder<N>` (with `image_encoder<N>` beside
it, found by name) continues at epoch N + 1 and replays the uninterrupted
run exactly: the optimizer restarts every epoch, the loader is (seed,
epoch)-deterministic and the dropout is seeded by the global step. `--mesh
DATAx1` trains data parallel over a launcher's ranks, one process per GPU
(the step is the single-process step on the global batch; only rank 0
writes snapshots and logs, and the attention grid is drawn by a single
process only, as JAX's). `--tensorboard` mirrors the metrics to `Log/tb`
where the tensorboard package is. `main` returns a summary of the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import pprint
import re

import numpy as np
import torch

def check_encoder_family(snap_inception: bool, live_inception: bool, img_path: str) -> None:
    """Refuse a --resume_from image encoder of the other family than the run
    builds (JAX's message)."""
    if snap_inception != live_inception:
        snap = "Inception" if snap_inception else "SimpleCNN"
        live = "Inception" if live_inception else "SimpleCNN"
        raise SystemExit(
            f"--resume_from image encoder {img_path} is a {snap} snapshot but this run builds "
            f"a {live} encoder; {'drop' if snap_inception else 'pass'} --simple-cnn to match "
            f"the snapshot's family")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train DAMSM encoders")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--data_dir", default="")
    parser.add_argument("--out_dir", default="../output")
    parser.add_argument("--manualSeed", type=int, default=100)
    parser.add_argument("--epochs", type=int, default=0, help="override cfg.TRAIN.MAX_EPOCH")
    parser.add_argument("--simple-cnn", action="store_true",
                        help="use the trainable SimpleCNNEncoder instead of Inception-v3 (no "
                             "zoo weights needed)")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed precision: bf16 CNN encoder compute")
    parser.add_argument("--inception_ckpt", default="",
                        help="local torchvision inception_v3 .pth to load")
    parser.add_argument("--resume_from", default="",
                        help="resume from a text_encoder<N>.{msgpack,pth} snapshot (the paired "
                             "image_encoder<N> file is loaded by name substitution and "
                             "training continues at epoch N+1)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="mirror metrics to TensorBoard event files under Log/tb")
    parser.add_argument("--csv", action="store_true",
                        help="mirror metrics to Log/metrics.csv")
    parser.add_argument("--mesh", default="",
                        help="data-parallel training over a device mesh, 'DATAx1' (e.g. "
                             "8x1), one process per GPU under torchrun; "
                             "cfg.TRAIN.BATCH_SIZE must be divisible by DATA")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the card) or cpu")
    return parser


def _datasets(cfg):
    from tgsr_tpu_torch.data.datasets import TextDataset, TextFaceDataset

    imsize = cfg.TREE.BASE_SIZE  # DAMSM configs: BRANCH_NUM 1, size 299
    if cfg.DATASET_NAME == "face":
        return tuple(TextFaceDataset(cfg.DATA_DIR, split=split, words_num=cfg.TEXT.WORDS_NUM,
                                     imsize=imsize) for split in ("train", "test"))
    return tuple(TextDataset(cfg.DATA_DIR, split=split, words_num=cfg.TEXT.WORDS_NUM,
                             embeddings_num=cfg.TEXT.CAPTIONS_PER_IMAGE, imsize=imsize)
                 for split in ("train", "test"))


def _make_mesh(parser, args, cfg):
    """--mesh -> a mesh or None, with JAX's messages; a mesh over more ranks
    than the launcher started exits naming torchrun."""
    from tgsr_tpu_torch.parallel.mesh import make_mesh, parse_mesh_arg
    from tgsr_tpu_torch.parallel.multihost import process_count

    if not args.mesh:
        if process_count() > 1:
            parser.error(f"{process_count()} ranks under a launcher train together only with "
                         f"--mesh (e.g. --mesh {process_count()}x1)")
        return None
    try:
        n_data, n_model = parse_mesh_arg(args.mesh)
    except ValueError:
        parser.error(f"--mesh expects DATAx1 (e.g. 8x1), got {args.mesh!r}")
    if n_model != 1:
        parser.error("DAMSM training has no model-parallel axis; use --mesh DATAx1")
    if cfg.TRAIN.BATCH_SIZE % n_data:
        parser.error(f"cfg.TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} is not divisible by the "
                     f"mesh data axis ({n_data})")
    try:
        return make_mesh(n_data, n_model, device=args.device)
    except ValueError as e:
        parser.error(str(e))


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    from tgsr_tpu_torch.parallel.multihost import initialize_distributed, is_main_process

    # join the launcher's process group before anything touches the card
    initialize_distributed(args.device)
    is_main = is_main_process()

    from tgsr_tpu_torch.checkpoints.from_jax import is_inception_state_dict
    from tgsr_tpu_torch.checkpoints.io import save_variables
    from tgsr_tpu_torch.checkpoints.reference import (load_image_encoder, load_text_encoder,
                                                      paired_path)
    from tgsr_tpu_torch.config import check_damsm, config_from_file
    from tgsr_tpu_torch.data.codec import encode_png
    from tgsr_tpu_torch.data.pipeline import BatchLoader
    from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer
    from tgsr_tpu_torch.parallel.mesh import batch_shards
    from tgsr_tpu_torch.utils.observability import MetricsLogger
    from tgsr_tpu_torch.utils.preemption import graceful_sigterm

    cfg = config_from_file(args.cfg_file, check_damsm)
    if args.data_dir:
        cfg = dataclasses.replace(cfg, DATA_DIR=args.data_dir)
    if is_main:
        pprint.pprint(cfg)
    np.random.seed(args.manualSeed)

    # output dirs (= pretrain_DAMSM.py:221-229)
    ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    out = os.path.join(args.out_dir, f"{cfg.DATASET_NAME}_DAMSM_{ts}")
    model_dir = os.path.join(out, "Model")
    image_dir = os.path.join(out, "Image")
    train_ds, val_ds = _datasets(cfg)
    mesh = _make_mesh(parser, args, cfg)

    trainer = DAMSMTrainer(cfg, train_ds.n_words, use_inception=not args.simple_cnn,
                           compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                           seed=args.manualSeed, device=args.device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(args.manualSeed))
    if args.inception_ckpt:
        trainer.load_state(state, cnn_sd=load_image_encoder(args.inception_ckpt))
        print("loaded inception backbone from", args.inception_ckpt)

    start_epoch = 0
    if args.resume_from:
        m = re.search(r"text_encoder(-?\d+)\.(msgpack|pth)$", args.resume_from)
        if not m:
            raise SystemExit(f"--resume_from must point at a text_encoder<N>.msgpack/.pth "
                             f"snapshot, got {args.resume_from!r}")
        start_epoch = max(int(m.group(1)) + 1, 0)
        img_path = paired_path(args.resume_from, "text_encoder", "image_encoder")
        cnn_sd = None
        if os.path.exists(img_path):
            cnn_sd = load_image_encoder(img_path)
            check_encoder_family(is_inception_state_dict(cnn_sd), trainer.use_inception,
                                 img_path)
        else:
            print(f"paired image encoder not found at {img_path}; text encoder only")
        text_sd = load_text_encoder(args.resume_from, cfg.RNN_TYPE)
        trainer.load_state(state, text_sd, cnn_sd)
        print(f"resumed encoders from {args.resume_from}; continuing at epoch {start_epoch}")

    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(image_dir, exist_ok=True)
    # rank 0 owns the metric files
    logger = (MetricsLogger(os.path.join(out, "Log"), csv=args.csv,
                            tensorboard=args.tensorboard) if is_main else None)
    train_loader = BatchLoader(train_ds, cfg.TRAIN.BATCH_SIZE, shuffle=True,
                               seed=args.manualSeed)
    val_batch = min(cfg.TRAIN.BATCH_SIZE, len(val_ds))
    if mesh is not None:
        # every batch must divide the data axis: round the val batch down
        n_data = batch_shards(mesh)
        val_batch = (val_batch // n_data) * n_data
        if val_batch == 0:
            print(f"val set ({len(val_ds)} items) smaller than the mesh data axis ({n_data}); "
                  f"skipping validation")
    val_loader = (BatchLoader(val_ds, val_batch, shuffle=False, drop_last=mesh is not None,
                              deterministic_captions=True) if val_batch else None)
    snapshots = []

    def snapshot(state, epoch):
        """= text_encoder%d / image_encoder%d, then the attention grid
        (pretrain_DAMSM.py:100-129)."""
        text_vars, cnn_vars = state.snapshot_variables()
        path = os.path.join(model_dir, f"text_encoder{epoch}.msgpack")
        snapshots.append(path)
        if is_main:  # the state is replicated; one rank writes
            save_variables(path, text_vars)
            save_variables(os.path.join(model_dir, f"image_encoder{epoch}.msgpack"), cnn_vars)
            print(f"snapshot @ epoch {epoch} -> {model_dir}")
        if mesh is not None and batch_shards(mesh) > 1:
            # the grid's eval step is a collective; a single process draws it
            return
        try:
            from tgsr_tpu_torch.utils.visualize import build_super_images

            batch = next(val_loader.epoch(0), None) if val_loader is not None else None
            if batch is None:
                batch = next(train_loader.epoch(0))
            _, attn = trainer.eval_step(state, trainer.device_batch(batch))
            r = int(np.sqrt(attn.shape[-1]))
            attn_maps = attn.cpu().numpy().reshape(attn.shape[0], attn.shape[1], r, r)
            imgs_f = np.asarray(batch["hr"][:4], np.float32) / 127.5 - 1.0
            grid, _ = build_super_images(imgs_f, np.asarray(batch["captions"][:4]),
                                         train_ds.vocab.ixtoword, attn_maps[:4], att_sze=r,
                                         max_word_num=cfg.TEXT.WORDS_NUM)
            if grid is not None:
                with open(os.path.join(image_dir, f"attention_maps{epoch}.png"), "wb") as f:
                    f.write(encode_png(grid))
        except Exception as e:  # the grid must never end a training run
            print(f"attention dump failed: {type(e).__name__}: {e}")

    epochs = args.epochs or cfg.TRAIN.MAX_EPOCH
    history = []
    try:
        with graceful_sigterm():
            state, history = trainer.fit(
                state, train_loader, val_loader, epochs=epochs, snapshot_fn=snapshot,
                snapshot_interval=cfg.TRAIN.SNAPSHOT_INTERVAL, logger=logger,
                start_epoch=start_epoch, global_step_offset=start_epoch * len(train_loader))
        for h in history[-5:]:
            print(h)
    except KeyboardInterrupt:  # = pretrain_DAMSM.py:293-295
        snapshot(state, -1)
        print("interrupted; snapshot saved")
    finally:
        if logger is not None:
            logger.close()
    return {"out_dir": out, "epochs": epochs, "start_epoch": start_epoch, "history": history,
            "snapshots": snapshots, "state": state, "trainer": trainer}


if __name__ == "__main__":
    main()
