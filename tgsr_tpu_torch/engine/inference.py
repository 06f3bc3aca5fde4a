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

`compute_dtype` is float32 or bfloat16, with the JAX pipeline's casts
(tgsr_tpu/engine/inference.py `_forward_fn`, `forward_scan`): the text
encoder runs in float32 and its outputs are cast; the LR image and every
floating-point parameter and buffer of both generators (BN statistics and
the blend `a` included) are cast; sr, the pyramid and the attention maps
come back float32, and uint8 egress rounds the float32 of the last image.
The up-head sites run `fused_up_head` (float32) or `fused_up_head_packed`
(bfloat16), whose weights are folded and packed once from the float32
weights before the cast.

int8 serving (`quant_scales`, bfloat16 compute only in this port; see
engine/quant.py and models/quantized.py): the scales are checked against the
float32 weights (keys, and the weights fingerprint when they carry one), and
each generator with a non-empty scales group is served by a quantized copy
made after the cast, as JAX quantizes the cast variables. Its convs launch
`int8_conv` and its GLU+requantize passes `glu_requant`; its last stage and
256 px scale run as modules (the quantized UpBlock, then the int8 head), so
the up-head kernels do not run. `calibrate_quant` records the scales on the
plain, unfused modules.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from tgsr_tpu_torch.checkpoints.from_jax import conv_sites
from tgsr_tpu_torch.config import Config
from tgsr_tpu_torch.engine.precision import COMPUTE_DTYPES, cast_floats
from tgsr_tpu_torch.engine.quant import (SPLIT_RES_GLU_SITES, check_scales,
                                         effective_split_glu, record_absmax,
                                         split_scales_meta)
from tgsr_tpu_torch.models.generator import GSRNetLow
from tgsr_tpu_torch.models.generator_hf import NetGHighWeight
from tgsr_tpu_torch.models.quantized import quantize_generator
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tgsr_tpu_torch.ops.blocks import nchw, nhwc
from tgsr_tpu_torch.ops.packed_tail import pack_up_head
from tgsr_tpu_torch.ops.up_head import up_head_site
from tgsr_tpu_torch.ops.up_head_packed import up_head_packed_site


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
    the blend weight `a`, which the reference state dict does not carry.
    `quant_scales` ({"netg": {...}, "netgh": {...}}, optionally with
    '_meta') selects int8 serving."""

    def __init__(self, cfg: Config, vocab_size: int,
                 text_sd: Mapping[str, Any], netg_sd: Mapping[str, Any],
                 netgh_sd: Mapping[str, Any], a: float = 0.5,
                 device: Union[str, torch.device] = "cuda",
                 return_attn: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 quant_scales: Optional[Mapping[str, Any]] = None):
        if cfg.TREE.BRANCH_NUM != 4 or cfg.RNN_TYPE != "LSTM":
            raise NotImplementedError(
                "the port serves the x8 geometry (BRANCH_NUM 4) with an LSTM "
                "text encoder")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: the port serves "
                             f"{COMPUTE_DTYPES}")
        if quant_scales and compute_dtype == torch.float32:
            raise NotImplementedError("int8 serving with float32 compute is not "
                                      "ported; use compute_dtype=torch.bfloat16")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.return_attn = return_attn
        self.compute_dtype = compute_dtype
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
        self.quant_scales, self.quant_meta = split_scales_meta(quant_scales or {})
        check_scales(self.quant_scales, self.netg, self.netgh, meta=self.quant_meta)
        # the up-head sites of the generators served unquantized, folded (and
        # packed) once from the float32 weights; the text encoder stays
        # float32
        self.netg_up_head = self._up_head_site(self.netg, "netg")
        self.netgh_up_head = self._up_head_site(self.netgh, "netgh")
        for module in (self.netg, self.netgh):
            cast_floats(module, compute_dtype)
            if self.device.type == "cuda":
                module.to(memory_format=torch.channels_last)
        # the modules that serve: int8 copies where a scales group is given,
        # quantized from the cast weights (after the layout change, which
        # would otherwise restride their int8 buffers)
        sites = conv_sites(self.netg, self.netgh)
        self.serve_netg, self.serve_netgh = (
            quantize_generator(module, sites[group], self.quant_scales[group],
                               effective_split_glu(self.quant_scales[group]),
                               SPLIT_RES_GLU_SITES)
            if self.quant_scales.get(group) else module
            for group, module in (("netg", self.netg), ("netgh", self.netgh)))

    def _up_head_site(self, generator, group: str
                      ) -> Optional[Callable[..., torch.Tensor]]:
        if self.quant_scales.get(group):
            return None  # int8: the UpBlock and its head run as quantized modules
        wts = generator.up_head_weights()
        if self.compute_dtype == torch.float32:
            return partial(up_head_site, wts)
        return partial(up_head_packed_site, pack_up_head(*wts, dtype=self.compute_dtype))

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _forward(self, lr: torch.Tensor, captions: torch.Tensor,
                 cap_lens: torch.Tensor, need_attn: bool):
        """lr [B, h, w, 3] float32 on the device -> (NCHW pyramid and attn
        maps, in the compute dtype)."""
        cdt = self.compute_dtype
        words, sent = self.text_encoder(captions, cap_lens)
        mask = captions == 0
        lr_c = nchw(lr.contiguous()).to(cdt)
        fake, att, _, _ = self.serve_netg(lr_c, sent.to(cdt), words.to(cdt), mask,
                                          need_attn, up_head=self.netg_up_head)
        return self.serve_netgh(lr_c, fake, up_head=self.netgh_up_head), att

    @torch.inference_mode()
    def calibrate_quant(self, lr, captions, cap_lens, margin: float = 1.1
                        ) -> Dict[str, Dict[str, float]]:
        """int8 activation scales from representative inputs (counterpart of
        tgsr_tpu's `SRPipeline.calibrate_quant`): one forward of the plain
        generators in the compute dtype, through their unfused modules, with
        every conv input's absmax recorded; netgh is calibrated on netg's
        unquantized pyramid. Returns {"netg": {...}, "netgh": {...}} of
        absmax * margin, keyed by the JAX conv paths, for `quant_scales=`."""
        cdt = self.compute_dtype
        captions = self._tensor(captions, torch.long)
        words, sent = self.text_encoder(captions, self._tensor(cap_lens, torch.long))
        lr_c = nchw(self._tensor(lr, torch.float32).contiguous()).to(cdt)
        sites = conv_sites(self.netg, self.netgh)
        with record_absmax(self.netg, sites["netg"]) as rec_g:
            fake, _, _, _ = self.netg(lr_c, sent.to(cdt), words.to(cdt), captions == 0)
        with record_absmax(self.netgh, sites["netgh"]) as rec_gh:
            self.netgh(lr_c, fake)
        return {group: {k: float(v) * margin for k, v in rec.items()}
                for group, rec in (("netg", rec_g), ("netgh", rec_gh))}

    @torch.inference_mode()
    def __call__(self, lr, captions, cap_lens) -> Dict[str, Any]:
        """Returns float32 {'sr': [B, H, W, 3], 'pyramid': [64, 128, 256 px]
        NHWC, and 'attn': [B, T, H, W] per stage when return_attn}."""
        fine, att = self._forward(self._tensor(lr, torch.float32),
                                  self._tensor(captions, torch.long),
                                  self._tensor(cap_lens, torch.long),
                                  self.return_attn)
        pyramid = [nhwc(f).float() for f in fine]
        out = {"sr": pyramid[-1], "pyramid": pyramid}
        if self.return_attn:
            out["attn"] = [a.float() for a in att]
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
            out[i] = nhwc(to_uint8(fine[-1].float()))
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
