"""Adversarial SR training entry point (counterpart of
tgsr_tpu/cli/train_gan.py): per-scale D steps, the joint G (netG + netGH)
step, KL and pixel MSE, the G EMA, and paired netG / netGH snapshots of the
EMA weights, through `engine/gan_trainer.GANTrainer`.

  python -m tgsr_tpu_torch.cli.train_gan --cfg <train yml> --data_dir <root> \\
      [--text_encoder text_encoder.pth] [--image_encoder image_encoder0.msgpack] \\
      [--epochs N] [--bf16] [--remat [low|high|all]] [--device cpu]

The x8 family (configs/train_faceSR_S8.yml) or the x16 one
(configs/train_faceSR_S16.yml: 32 px -> 512 px, `--remat all` as the JAX
CLI runs it); `--remat` alone or `all` rematerialises both generators in the
backward, `low` / `high` GSRNetLow's stages / NetGHighWeight's blocks only.

The JAX CLI's flags, defaults and messages, plus `--device` (default
"cuda"; "cpu" runs every kernel site's plain version). Each step's batch is
preprocessed on the device (`data.pipeline.device_preprocess`); metrics go
to `<out_dir>/Log/metrics.jsonl` (and `metrics.csv` with --csv); every
TRAIN.SNAPSHOT_INTERVAL steps `<out_dir>/Model/netG_it{N}.msgpack` and
`netGH_it{N}.msgpack` (flax trees of the EMA weights and the BN stats, which
JAX's `load_variables` and the port's `SRPipeline` read). A non-finite
metric aborts (never snapshotted); SIGTERM and Ctrl-C write the last step's
snapshot pair and stop. JAX's orbax train-state checkpoints and the flags
that need them or other unported parts (--resume, --mesh, --fsdp,
--tensorboard) exit with the ROADMAP item that ports them. --image_encoder
(a `cli.pretrain_damsm` snapshot, or a reference image_encoder .pth) adds
the DAMSM terms; its family comes from the tree, as JAX's.
`main` returns a summary of the run.
"""

from __future__ import annotations

import argparse
import os
import pprint
import time

import numpy as np
import torch

LOSS_TERMS = ("adv", "pixel", "kl")
# flags of the JAX CLI that need what the port has not got yet: the ROADMAP
# item that ports it
REFUSED = {
    "resume": "ROADMAP A 10 (orbax train-state checkpoints as torch.distributed.checkpoint)",
    "mesh": "ROADMAP A 10 (parallel/mesh.py as torch.distributed)",
    "fsdp": "ROADMAP A 10 (parallel/mesh.py as torch.distributed)",
    "tensorboard": "ROADMAP A 10 (utils/observability.py's TensorBoard mirror)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train TGSR GAN")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--data_dir", default="")
    parser.add_argument("--out_dir", default="../output/gan")
    parser.add_argument("--text_encoder", default="",
                        help="trained DAMSM text encoder (.msgpack/.pth)")
    parser.add_argument("--image_encoder", default="",
                        help="trained DAMSM image encoder (.msgpack snapshot or "
                             "reference .pth; adds the DAMSM terms)")
    parser.add_argument("--epochs", type=int, default=0)
    parser.add_argument("--manualSeed", type=int, default=100)
    parser.add_argument("--log_every", type=int, default=20)
    parser.add_argument("--remat", nargs="?", const=True, default=False,
                        choices=[True, False, "all", "low", "high"],
                        help="rematerialize G activations in the backward: --remat (both "
                             "generators) or --remat low|high (GSRNetLow / NetGHighWeight "
                             "only); memory only, the step is the same")
    parser.add_argument("--loss_weight", action="append", default=[], metavar="TERM=W",
                        help="scale a G composite term, e.g. --loss_weight adv=0.01 "
                             "(terms: adv, pixel, kl; default 1.0 each)")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed precision: bf16 G/D compute, f32 master "
                             "weights/opt/losses")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest train-state checkpoint (not ported yet)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="mirror the metrics to TensorBoard (not ported yet)")
    parser.add_argument("--csv", action="store_true",
                        help="mirror the JSONL metrics to Log/metrics.csv")
    parser.add_argument("--eval_every", type=int, default=0,
                        help="every N steps, log PSNR-Y/SSIM of the EMA generator on a fixed "
                             "validation batch (a train batch if the val split is empty); "
                             "0 disables")
    parser.add_argument("--eval_batch", type=int, default=16,
                        help="validation batch size for --eval_every")
    parser.add_argument("--nan_check_every", type=int, default=50,
                        help="every N steps, fetch the metrics and ABORT if any is "
                             "non-finite; 0 disables")
    parser.add_argument("--mesh", default="", help="train over a device mesh (not ported yet)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard params/optimizer/EMA (not ported yet)")
    parser.add_argument("--init_netg", default="",
                        help="warm-start G from a reference netG_epoch_*.pth or this "
                             "trainer's own netG_it*.msgpack (netGH by name substitution). "
                             "Defaults to cfg.TRAIN.NET_G when that path exists. EMA starts "
                             "from the loaded weights")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the kernels) or cpu (their plain versions)")
    return parser


def _dataset(cfg, split: str):
    from tgsr_tpu_torch.data.datasets import TextFaceDataset, TextSRDataset

    if cfg.DATASET_NAME == "face":
        return TextFaceDataset(cfg.DATA_DIR, split=split, words_num=cfg.TEXT.WORDS_NUM,
                               imsize=cfg.imsize)
    return TextSRDataset(cfg.DATA_DIR, split=split, words_num=cfg.TEXT.WORDS_NUM,
                         embeddings_num=cfg.TEXT.CAPTIONS_PER_IMAGE, imsize=cfg.imsize)


def _device_batch(cfg, batch, device):
    """A host batch -> the trainer's batch, preprocessed on `device`."""
    from tgsr_tpu_torch.data.pipeline import device_preprocess

    pre = device_preprocess(torch.from_numpy(batch["hr"]).to(device), cfg.TREE.BRANCH_NUM,
                            cfg.TREE.BASE_SIZE, with_blur=False)
    return {"lr": pre["lr"], "real_pyramid": pre["pyramid"][1:],
            "captions": torch.from_numpy(batch["captions"]).to(device),
            "cap_lens": torch.from_numpy(batch["cap_lens"]).to(device),
            "class_ids": torch.from_numpy(batch["class_ids"]).to(device)}


def load_image_encoder_module(path: str, nef: int):
    """The image encoder of a snapshot (`.msgpack`) or a reference `.pth`,
    its family from the tree (JAX's `"inception" in params`), loaded
    strict."""
    from tgsr_tpu_torch.checkpoints.from_jax import is_inception_state_dict
    from tgsr_tpu_torch.checkpoints.reference import load_image_encoder
    from tgsr_tpu_torch.models.image_encoder import make_image_encoder

    if not os.path.exists(path):
        raise SystemExit(f"--image_encoder not found: {path}")
    sd = load_image_encoder(path)
    module = make_image_encoder(not is_inception_state_dict(sd), nef)
    module.load_state_dict(sd, strict=True)
    return module


def _abort_if_nonfinite(metrics, it) -> None:
    """Stop loudly instead of training garbage: fetching the metrics forces
    the step. The poisoned state is not snapshotted."""
    bad = [k for k, v in metrics.items() if not np.isfinite(float(v))]
    if bad:
        raise SystemExit(f"NaN/Inf in metrics {bad} at it {it}; restart from the last "
                         f"snapshot (--init_netg) after lowering the lr.")


def _snapshot(state, model_dir: str, it: int) -> str:
    from tgsr_tpu_torch.checkpoints.io import save_variables

    netg_vars, netgh_vars = state.snapshot_variables()
    path = os.path.join(model_dir, f"netG_it{it}.msgpack")
    save_variables(path, netg_vars)
    save_variables(os.path.join(model_dir, f"netGH_it{it}.msgpack"), netgh_vars)
    return path


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    loss_weights = {}
    for spec in args.loss_weight:
        term, _, w = spec.partition("=")
        try:
            loss_weights[term] = float(w)
        except ValueError:
            parser.error(f"--loss_weight expects adv|pixel|kl=FLOAT, got {spec!r}")
        if term not in LOSS_TERMS:
            parser.error(f"--loss_weight expects adv|pixel|kl=FLOAT, got {spec!r}")
    for flag, item in REFUSED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: not ported to tgsr_tpu_torch yet; {item}")

    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.checkpoints.reference import load_generator_pair, load_text_encoder
    from tgsr_tpu_torch.cli.test import load_config
    from tgsr_tpu_torch.config import check_trained
    from tgsr_tpu_torch.data.pipeline import BatchLoader
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.utils.observability import MetricsLogger, StepTimer
    from tgsr_tpu_torch.utils.preemption import graceful_sigterm

    cfg = check_trained(load_config(args.cfg_file, args.data_dir))
    pprint.pprint(cfg)
    np.random.seed(args.manualSeed)
    ds = _dataset(cfg, "train")
    if args.text_encoder:
        text_sd = load_text_encoder(args.text_encoder, cfg.RNN_TYPE)
    else:
        print("WARNING: no trained text encoder given; using seeded init")
        text_sd = seeded_text_state_dict(cfg, ds.n_words,
                                         torch.Generator().manual_seed(args.manualSeed))
    image_encoder = None
    if args.image_encoder:
        image_encoder = load_image_encoder_module(args.image_encoder, cfg.TEXT.EMBEDDING_DIM)
        print(f"DAMSM terms from {type(image_encoder).__name__} {args.image_encoder}")
    trainer = GANTrainer(cfg, ds.n_words, text_sd, image_encoder=image_encoder,
                         compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                         loss_weights=loss_weights or None, remat=args.remat,
                         device=args.device)
    device = trainer.device
    state = trainer.init_state(torch.Generator().manual_seed(args.manualSeed))
    loader = BatchLoader(ds, cfg.TRAIN.BATCH_SIZE, shuffle=True, seed=args.manualSeed)
    model_dir = os.path.join(args.out_dir, "Model")
    os.makedirs(model_dir, exist_ok=True)

    init_netg = args.init_netg or cfg.TRAIN.NET_G
    if init_netg and os.path.exists(init_netg):
        from tgsr_tpu_torch.checkpoints.reference import paired_path

        trainer.load_state(state, *load_generator_pair(cfg, init_netg))
        print(f"warm-started G from {init_netg} (+{paired_path(init_netg, 'netG', 'netGH')})")
    elif args.init_netg:
        raise SystemExit(f"--init_netg not found: {args.init_netg}")

    logger = MetricsLogger(os.path.join(args.out_dir, "Log"), csv=args.csv)
    timer = StepTimer()
    val_db = None
    if args.eval_every:
        vds = _dataset(cfg, "test")
        src, note = (vds, "val") if len(vds) else (ds, "train (val split empty)")
        vloader = BatchLoader(src, min(args.eval_batch, len(src)), shuffle=False,
                              drop_last=False, deterministic_captions=True)
        vb = next(vloader.epoch(0))
        val_db = _device_batch(cfg, vb, device)
        print(f"periodic eval every {args.eval_every} steps on {len(vb['hr'])} {note} images")

    epochs = args.epochs or cfg.TRAIN.MAX_EPOCH
    it, snapshots, t0 = 0, [], time.perf_counter()
    try:
        with graceful_sigterm():
            for epoch in range(epochs):
                for batch in loader.epoch(epoch):
                    metrics = trainer.train_step(state, _device_batch(cfg, batch, device))
                    if args.nan_check_every and it % args.nan_check_every == 0:
                        _abort_if_nonfinite(metrics, it)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)  # the step's time, not its launch
                    ema_ms = timer.tick()
                    if val_db is not None and it % args.eval_every == 0:
                        em = trainer.eval_metrics(state, val_db)
                        vm = {"val_psnr_y": float(em["psnr_y"]), "val_ssim_y": float(em["ssim_y"])}
                        print(f"epoch {epoch} it {it}: " + " ".join(
                            f"{k}={v:.4f}" for k, v in vm.items()))
                        logger.log(it, **vm)
                    if it % args.log_every == 0:
                        print(f"epoch {epoch} it {it}: " + " ".join(
                            f"{k}={float(v):.4f}" for k, v in sorted(metrics.items()))
                            + (f" [{ema_ms:.0f} ms/step]" if ema_ms else ""))
                        logger.log(it, **metrics)
                    it += 1
                    if cfg.TRAIN.SNAPSHOT_INTERVAL and it % cfg.TRAIN.SNAPSHOT_INTERVAL == 0:
                        if args.nan_check_every:
                            _abort_if_nonfinite(metrics, it)
                        snapshots.append(_snapshot(state, model_dir, it))
    except KeyboardInterrupt:
        print("interrupted; saving a final snapshot")
        if it and f"netG_it{it}.msgpack" not in map(os.path.basename, snapshots):
            snapshots.append(_snapshot(state, model_dir, it))
    finally:
        logger.close()
    print("training done;", it, "steps; snapshots in", model_dir)
    return {"steps": it, "epochs": epochs, "snapshots": snapshots, "out_dir": args.out_dir,
            "seconds": time.perf_counter() - t0, "state": state, "trainer": trainer}


if __name__ == "__main__":
    main()
