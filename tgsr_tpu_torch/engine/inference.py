"""x8 text-guided SR inference (counterpart of tgsr_tpu/engine/inference.py
`SRPipeline`): caption -> TextEncoder -> GSRNetLow -> NetGHighWeight -> SR.

Public layouts are the JAX package's: lr [B, h, w, 3] in [-1, 1] (or uint8
for `forward_scan` / `sr_batched`), captions [B, T] token ids with 0 = pad,
sr [B, H, W, 3]. Inside, the generators run NCHW, in channels_last memory on
the card, so NHWC <-> NCHW at the kernel sites costs no copy.

The pipeline runs on `device`, "cuda" unless the caller asks for the CPU.
On the card the three attention sites and the two up-head sites launch the
port's CUDA kernels; on the CPU they run the plain versions, so a pipeline
built with device="cpu" on the same weights is the reference the card's is
held against.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from tgsr_tpu_torch.config import Config
from tgsr_tpu_torch.models.generator import GSRNetLow
from tgsr_tpu_torch.models.generator_hf import NetGHighWeight
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tgsr_tpu_torch.ops.blocks import nchw, nhwc


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tgsr_tpu_torch runs on a CUDA card by default and "
                           "none is available; pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def to_uint8(sr: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8, round(clip((sr + 1) * 127.5, 0, 255)) with
    round-half-to-even, as the JAX package."""
    return torch.round(torch.clamp((sr + 1.0) * 127.5, 0, 255)).to(torch.uint8)


class SRPipeline:
    """Text-guided SR inference: (LR, captions, cap_lens) -> SR.

    Construct from reference-named state dicts (`checkpoints.from_jax`) and
    the blend weight `a`, which the reference state dict does not carry."""

    def __init__(self, cfg: Config, vocab_size: int,
                 text_sd: Mapping[str, Any], netg_sd: Mapping[str, Any],
                 netgh_sd: Mapping[str, Any], a: float = 0.5,
                 device: Union[str, torch.device] = "cuda",
                 return_attn: bool = False):
        if cfg.TREE.BRANCH_NUM != 4 or cfg.RNN_TYPE != "LSTM":
            raise NotImplementedError(
                "the port serves the x8 geometry (BRANCH_NUM 4) with an LSTM "
                "text encoder")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.return_attn = return_attn
        emb = cfg.TEXT.EMBEDDING_DIM
        self.text_encoder = TextEncoder(vocab_size, 300, emb)
        self.netg = GSRNetLow(cfg.GAN.GF_DIM, emb, cfg.GAN.CONDITION_DIM,
                              cfg.n_stages, cfg.GAN.R_NUM)
        self.netgh = NetGHighWeight(cfg.GAN.GF_DIM)
        for module, sd in ((self.text_encoder, text_sd), (self.netg, netg_sd),
                           (self.netgh, netgh_sd)):
            module.load_state_dict(sd, strict=True)
            module.to(self.device).eval()
        self.netgh.a.fill_(float(a))
        if self.device.type == "cuda":
            self.netg.to(memory_format=torch.channels_last)
            self.netgh.to(memory_format=torch.channels_last)
        # the two up-head sites' folded BN and HWIO weights, made once
        self.netg_up_head = self.netg.up_head_weights()
        self.netgh_up_head = self.netgh.up_head_weights()

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _forward(self, lr: torch.Tensor, captions: torch.Tensor,
                 cap_lens: torch.Tensor, need_attn: bool):
        """lr [B, h, w, 3] float on the device -> (NCHW pyramid, attn maps)."""
        words, sent = self.text_encoder(captions, cap_lens)
        mask = captions == 0
        lr_c = nchw(lr.contiguous())
        fake, att, _, _ = self.netg(lr_c, sent, words, mask, need_attn,
                                    up_head=self.netg_up_head)
        return self.netgh(lr_c, fake, up_head=self.netgh_up_head), att

    @torch.inference_mode()
    def __call__(self, lr, captions, cap_lens) -> Dict[str, Any]:
        """Returns {'sr': [B, H, W, 3], 'pyramid': [64, 128, 256 px] NHWC,
        and 'attn': [B, T, H, W] per stage when return_attn}."""
        fine, att = self._forward(self._tensor(lr, torch.float32),
                                  self._tensor(captions, torch.long),
                                  self._tensor(cap_lens, torch.long),
                                  self.return_attn)
        pyramid = [nhwc(f) for f in fine]
        out = {"sr": pyramid[-1], "pyramid": pyramid}
        if self.return_attn:
            out["attn"] = att
        return out

    @torch.inference_mode()
    def forward_scan(self, lr, captions, cap_lens) -> torch.Tensor:
        """lr [M, B, h, w, 3] (uint8, or float in [-1, 1]), captions
        [M, B, T], cap_lens [M, B] -> uint8 SR [M, B, H, W, 3] on the device,
        one microbatch of B after another."""
        lr = self._tensor(lr)
        captions = self._tensor(captions, torch.long)
        cap_lens = self._tensor(cap_lens, torch.long)
        s = self.cfg.scale
        m, b, h, w, _ = lr.shape
        out = torch.empty((m, b, h * s, w * s, 3), dtype=torch.uint8,
                          device=self.device)
        for i in range(m):
            lr_i = lr[i]
            if lr_i.dtype == torch.uint8:
                lr_i = lr_i.float() / 127.5 - 1.0
            fine, _ = self._forward(lr_i.float(), captions[i], cap_lens[i], False)
            out[i] = nhwc(to_uint8(fine[-1]))
        return out

    def sr_batched(self, lr, captions, cap_lens, microbatch: int) -> np.ndarray:
        """Any number N of images, in ceil(N / microbatch) microbatches of
        balanced size: the batch is cut to ceil(N / m) so N = 65 at
        microbatch 64 runs 2 x 33, not 2 x 64. The tail is padded by
        replicating images from the start and stripped after. Peak memory is
        set by the microbatch, not N. Returns uint8 [N, H, W, 3] on the host."""
        lr = np.asarray(lr)
        captions = np.asarray(captions)
        cap_lens = np.asarray(cap_lens)
        n = lr.shape[0]
        s = self.cfg.scale
        if n == 0:
            return np.empty((0, lr.shape[1] * s, lr.shape[2] * s, 3), np.uint8)
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        m = -(-n // min(microbatch, n))
        b = -(-n // m)
        if m * b > n:
            sel = np.arange(m * b) % n
            lr, captions, cap_lens = lr[sel], captions[sel], cap_lens[sel]
        srs = self.forward_scan(lr.reshape(m, b, *lr.shape[1:]),
                                captions.reshape(m, b, captions.shape[-1]),
                                cap_lens.reshape(m, b))
        return srs.reshape(m * b, *srs.shape[2:])[:n].cpu().numpy()
