"""Batched evaluation harness (counterpart of tgsr_tpu/engine/evaluator.py
`evaluate_sr`): HR uint8 -> antialiased bilinear degrade -> SR through the
pipeline's `__call__` -> Y-channel PSNR and SSIM against the HR, on the
pipeline's device. DAMSM retrieval ranking (`rank_r_precision`) needs the
image encoder and is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from tgsr_tpu_torch.ops.image import (denormalize_to_uint8, normalize_uint8, psnr_batch,
                                      resize, rgb2y, ssim)


@torch.inference_mode()
def evaluate_sr(pipeline, batches: Iterable[Dict[str, np.ndarray]],
                scale: Optional[int] = None, max_images: Optional[int] = None
                ) -> Dict[str, float]:
    """Runs the eval protocol over host batches ({"hr": uint8 [B, H, W, 3],
    "captions", "cap_lens", ...}) and returns the mean Y-channel PSNR
    (BT.601, the reference's metric) and SSIM, the number of images, and
    `images_per_sec_host_e2e`: a host end-to-end rate (degrade, forward,
    metrics and their copy to the host), not a device throughput.

    Each batch's device work runs under the pipeline's lock, so that it
    never overlaps another thread's graph capture on the same pipeline."""
    scale = scale or pipeline.cfg.scale
    psnrs: List[float] = []
    ssims: List[float] = []
    n = 0
    t0 = time.perf_counter()
    for batch in batches:
        with pipeline.lock:
            hr = torch.as_tensor(np.asarray(batch["hr"]), device=pipeline.device)
            h, w = hr.shape[1:3]
            lr = resize(normalize_uint8(hr), (h // scale, w // scale), "bilinear")
            sr = pipeline(lr, batch["captions"], batch["cap_lens"])["sr"]
            y_sr = rgb2y(denormalize_to_uint8(sr)).float()[..., None]
            y_hr = rgb2y(hr).float()[..., None]
            psnrs.extend(psnr_batch(y_sr, y_hr).tolist())
            ssims.extend(ssim(y_sr, y_hr).tolist())
        n += hr.shape[0]
        if max_images and n >= max_images:
            break
    dt = time.perf_counter() - t0
    return {
        "psnr_y": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim_y": float(np.mean(ssims)) if ssims else float("nan"),
        "images": n,
        "images_per_sec_host_e2e": n / dt if dt > 0 else float("nan"),
    }
