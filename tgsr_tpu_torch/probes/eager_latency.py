"""Eager B = 1 latency of each serving path on the card: what a call that
is not replayed as a CUDA graph costs the host (the custom ops of
ops/library.py dispatch through Python on every eager call).

    python -m tgsr_tpu_torch.probes.eager_latency [--iters 200]

The face S8 pipeline at full width, seeded weights (int8 scales from the
bfloat16 pipeline's calibration on 16 images), runs `SRPipeline._serve`
eagerly at B = 1 under inference mode, synchronised after each call, in
float32, bfloat16 and int8; prints the p50 and p99 of the host clock per
path (the first 20 calls dropped), the card's name and power limit, and
which tree's package ran. To hold two trees against each other in one
call, run this file from one tree with the other's package first on the
path, in turns:

    PYTHONPATH=<other tree> python <this tree>/tgsr_tpu_torch/probes/eager_latency.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args(argv)

    import tgsr_tpu_torch
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("eager_latency times the card: no CUDA card is available")
    _build.build()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = face_s8_config()
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lr = rng.uniform(-1, 1, (16, 32, 32, 3)).astype(np.float32)
    cap = rng.integers(1, 41, (16, cfg.TEXT.WORDS_NUM))
    lens = np.full(16, cfg.TEXT.WORDS_NUM)
    scales = SRPipeline(cfg, 41, *sds, compute_dtype=torch.bfloat16).calibrate_quant(
        lr, cap, lens)
    x = torch.as_tensor(lr[:1], device="cuda")
    c = torch.as_tensor(cap[:1], device="cuda")
    n = torch.as_tensor(lens[:1], device="cuda")
    out = {"package": tgsr_tpu_torch.__file__,
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    for tag in ("float32", "bfloat16", "int8"):
        kw = dict(compute_dtype=torch.float32 if tag == "float32" else torch.bfloat16)
        if tag == "int8":
            kw["quant_scales"] = scales
        pipe = SRPipeline(cfg, 41, *sds, **kw)
        ms = []
        with torch.inference_mode():
            for _ in range(args.iters + 20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe._serve(x, c, n)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        ms = np.asarray(ms[20:])
        out[tag] = {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
