"""Batched evaluation harness (counterpart of tgsr_tpu/engine/evaluator.py
`evaluate_sr`, `_rank_sims` and `rank_r_precision`): HR uint8 ->
antialiased bilinear degrade -> SR through the pipeline's `__call__` ->
Y-channel PSNR and SSIM against the HR, on the pipeline's device; and the
DAMSM retrieval ranking of generated images by their captions, the
similarity matrices on the device (the captions in blocks), the ranking on
the host.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tgsr_tpu_torch.engine.precision import float32_math
from tgsr_tpu_torch.losses.damsm import sent_similarity, words_similarity
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


# the elements of one [images, captions, T, R] attention block of the
# ranking: 2^27 float32 (512 MiB), a few such tensors live at once
RANK_BLOCK_ELEMS = 1 << 27


@torch.no_grad()
@float32_math()
def _rank_sims(image_features, cnn_codes, words_embs, sent_embs, cap_lens,
               g1: float, g2: float, g3: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [image, caption] word-level and sentence-level DAMSM similarity
    matrices, on the device of the inputs. The words similarity takes the
    captions in blocks against every image, so that its attention tensors
    hold at most RANK_BLOCK_ELEMS elements each ([N, N, T, R] whole would
    be 21 GB at N = 1,000); each column is the one a single call gives."""
    n, r = image_features.shape[:2]
    block = max(1, RANK_BLOCK_ELEMS // (n * words_embs.shape[1] * r))
    words = torch.cat([words_similarity(image_features, words_embs[lo:lo + block],
                                        cap_lens[lo:lo + block], g1, g2)
                       for lo in range(0, words_embs.shape[0], block)], dim=1)
    return words, sent_similarity(cnn_codes, sent_embs, g3)


def rank_r_precision(image_features, cnn_codes, words_embs, sent_embs, cap_lens,
                     gammas: Sequence[float] = (4.0, 5.0, 10.0), top_k: int = 1
                     ) -> Dict[str, float]:
    """DAMSM retrieval ranking over generated results (the TextSRGTDataset
    use-case, datasets.py:1721-1885): for each image, every caption ranked
    by the word- and the sentence-level similarity; R@k is the fraction of
    images whose own caption ranks in the top k. Inputs: region features
    [N, R, E], codes [N, E], word embeddings [N, T, E], sentences [N, E],
    lengths [N], tensors (on any device) or numpy."""
    t = lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    feats = t(image_features)
    dev = feats.device
    w_sim, s_sim = (x.cpu().numpy() for x in _rank_sims(
        feats, t(cnn_codes).to(dev), t(words_embs).to(dev), t(sent_embs).to(dev),
        t(cap_lens).to(dev), float(gammas[0]), float(gammas[1]), float(gammas[2])))
    n = w_sim.shape[0]

    def r_at_k(sim):  # [image, caption]; the ranking is host work
        order = np.argsort(-sim, axis=1)[:, :top_k]
        return float(np.mean((order == np.arange(n)[:, None]).any(axis=1).astype(np.float32)))

    return {f"word_r@{top_k}": r_at_k(w_sim), f"sent_r@{top_k}": r_at_k(s_sim), "n": n}
