"""Int8 serving: quantizers, site sets and scale bookkeeping (counterpart of
tgsr_tpu/engine/quant.py, whose semantics and numbers it keeps).

Weights are quantized per output channel (symmetric absmax int8), inputs
per tensor with a calibrated absmax `scale` (step = max(scale, 1e-12) / 127,
round half to even, clipped to +-127); the convs accumulate in int32 and are
dequantized per output channel in float32. A scales dict is
{"netg": {...}, "netgh": {...}}, keyed by the JAX package's conv paths
(`h_net1/residual_0/conv1`, `upscale8x/conv`), so a JSON that `tgsr_tpu`'s
`calibrate_quant` / `cli.calibrate` wrote loads as it is. The table from
those keys to the port's modules is `checkpoints.from_jax.conv_sites`.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tgsr_tpu_torch.checkpoints.from_jax import conv_sites
from tgsr_tpu_torch.ops.blocks import BN_EPS
from tgsr_tpu_torch.ops.quantize import QMAX, act_step, quantize_act  # noqa: F401 (re-exported)


# UpBlocks whose GLU output feeds a following int8 conv (the next stage's
# ResBlock, the next upscale); the split is numerically exact, so in the
# port these sets only decide where a GLU output leaves as int8
SPLIT_GLU_INT8_CONSUMERS = frozenset({
    "h_net1/upsample/conv", "h_net2/upsample/conv",
    "upscale2x/conv", "upscale4x/conv",
})
# UpBlocks whose GLU output feeds only image heads
HEAD_FEEDING_UPBLOCKS = frozenset({
    "h_net3/upsample/conv", "upscale8x/conv", "upscale16x/conv",
})
# UpBlock convs served by phases (models/quantized.QuantUpBlockPhases, JAX's
# `_fused_up_int8`): one 2x2 int8 conv per output parity class at the source
# resolution, the transformed kernel quantized per phase and output channel.
# Empty, as JAX's: an opt-in (SRPipeline's `fused_up`)
FUSED_UP_SITES = frozenset()
# the one int8 consumer of a head-feeding UpBlock: with the heads quantized,
# the block's GLU output is quantized with this conv's scale (glu_requant)
# and the head takes it as it is
FUSED_UP_OUT_CONSUMER = {
    "h_net3/upsample/conv": "img_net3/conv",
    "upscale8x/conv": "conv_output/conv",
    "upscale16x/conv": "conv_output/conv",
}
# ResBlock / residual-sequence paths whose conv1 -> BN -> GLU -> conv2 runs
# as one quantized block (conv1, glu_requant, conv2 with a float32 output)
SPLIT_RES_GLU_SITES = frozenset(
    {
        "h_net1/residual_0", "h_net1/residual_1",
        "h_net2/residual_0", "h_net2/residual_1",
        "h_net3/residual_0", "h_net3/residual_1",
        "residual24", "residual48", "residual816",
    }
    | {f"residual_{i}" for i in range(6)}
)

SCALES_META_KEY = "_meta"
Scales = Dict[str, Dict[str, float]]


def heads_quantized(scales: Mapping[str, float]) -> bool:
    """True when the scales dict quantizes the image heads."""
    return any("img_net" in k or "conv_output" in k for k in scales)


def effective_split_glu(scales: Mapping[str, float]) -> frozenset:
    """The UpBlock split set for a scales group: the int8-consumer sites,
    plus the head-feeding sites when the heads are quantized."""
    if heads_quantized(scales):
        return SPLIT_GLU_INT8_CONSUMERS | HEAD_FEEDING_UPBLOCKS
    return SPLIT_GLU_INT8_CONSUMERS


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW weight -> (int8 OIHW weight, float32 step [O]), symmetric absmax
    per output channel: w ~= wq * step[:, None, None, None]."""
    w32 = w.float()
    step = torch.clamp(w32.abs().amax(dim=(1, 2, 3)), min=1e-12) / QMAX
    wq = torch.round(w32 / step[:, None, None, None]).to(torch.int8)
    return wq, step


def bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm folded to a float32 (mul, add), from the module's own
    (possibly bfloat16) parameters and statistics, eps 1e-5."""
    mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    add = bn.bias.float() - bn.running_mean.float() * mul
    return mul, add


def merge_scales(*dicts: Mapping[str, float]) -> Dict[str, float]:
    """Pointwise max over several calibration runs."""
    out: Dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def drop_head_scales(scales: Mapping[str, Mapping[str, float]]) -> Scales:
    """Remove the image-head convs (img_net*, conv_output) so that they run
    in the compute dtype."""
    return {g: {k: v for k, v in d.items()
                if "img_net" not in k and "conv_output" not in k}
            for g, d in scales.items()}


def split_scales_meta(scales: Mapping[str, Any]) -> Tuple[Scales, Dict[str, Any]]:
    """Separate the optional '_meta' provenance entry from the groups."""
    meta = scales.get(SCALES_META_KEY) or {}
    return {k: v for k, v in scales.items() if k != SCALES_META_KEY}, dict(meta)


def weights_fingerprint(netg: nn.Module, netgh: nn.Module) -> str:
    """sha256 (first 16 hex chars) over the conv kernels the int8 path
    quantizes, as `tgsr_tpu`'s `weights_fingerprint` takes it: group/JAX
    path names in sorted order, each kernel as float32 HWIO bytes. Give it
    the float32 modules (before any compute-dtype cast)."""
    h = hashlib.sha256()
    tables = conv_sites(netg, netgh)
    for group, module in (("netg", netg), ("netgh", netgh)):
        for key, path in sorted(tables[group].items()):
            h.update(f"{group}/{key}".encode())
            w = module.get_submodule(path).weight.detach().float().cpu()
            h.update(np.ascontiguousarray(w.permute(2, 3, 1, 0).numpy()).tobytes())
    return h.hexdigest()[:16]


def check_scales(scales: Mapping[str, Mapping[str, float]], netg: nn.Module,
                 netgh: nn.Module, meta: Optional[Mapping[str, Any]] = None,
                 source: str = "quant_scales") -> None:
    """Refuse scales that would apply silently wrong: an unknown group, a
    group whose keys match no conv of the loaded generators (or only some
    of them), and, when the scales carry a weights fingerprint in '_meta',
    weights other than those they were calibrated on."""
    tables = conv_sites(netg, netgh)
    for group, d in scales.items():
        sites = tables.get(group)
        if sites is None:
            raise ValueError(f"{source}: unknown scales group {group!r} "
                             f"(expected {sorted(tables)})")
        if not d:
            continue
        unknown = sorted(k for k in d if k not in sites)
        if len(unknown) == len(d):
            raise ValueError(
                f"{source}: no {group!r} scales key matches any conv of the "
                f"loaded generators (sample keys: {unknown[:4]}; model convs: "
                f"{sorted(sites)[:4]}...): calibrated for another family?")
        if unknown:
            raise ValueError(
                f"{source}: {len(unknown)} {group!r} scales key(s) match no "
                f"conv of the loaded generators (e.g. {unknown[:4]}): family "
                "mismatch or stale scales; recalibrate")
    want = (meta or {}).get("weights_fingerprint")
    if want:
        got = weights_fingerprint(netg, netgh)
        if got != want:
            raise ValueError(
                f"{source}: weights fingerprint mismatch (scales {want}, loaded "
                f"weights {got}): these scales were calibrated on other weights "
                "and would mis-clip activations. Recalibrate with "
                "SRPipeline.calibrate_quant, or delete the '_meta' entry to "
                "reuse them deliberately.")


def _shipped_scales(filename: str, heads: bool) -> Scales:
    path = Path(__file__).resolve().parents[1] / "checkpoints" / filename
    scales = json.loads(path.read_text())
    return scales if heads else drop_head_scales(scales)


def face_s8_scales(heads: bool = True) -> Scales:
    """The shipped calibration of the reference face_S8 checkpoints (a
    byte-identical copy of the JAX package's face_s8_int8_scales.json,
    '_meta' with its weights fingerprint included). heads=False drops the
    image heads' scales."""
    return _shipped_scales("face_s8_int8_scales.json", heads)


def x16_scales(heads: bool = True) -> Scales:
    """The shipped calibration of the x16 family (a byte-identical copy of
    the JAX package's x16_int8_scales.json). The reference ships no x16
    checkpoint, so it was calibrated on the JAX package's seed-0 init of
    the S16 geometry (examples/x16_bench.py), whose fingerprint its '_meta'
    carries: `check_scales` takes it only for those weights."""
    return _shipped_scales("x16_int8_scales.json", heads)


@contextlib.contextmanager
def record_absmax(module: nn.Module, sites: Mapping[str, str]
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """Forward pre-hooks on the convs of `sites` ({JAX key: module path})
    that keep, per key, the max |input| over every call (conv_output runs
    three times a forward, four in x16; the x16 family's tied stage runs
    three times and its tied head four, each under one key). The UpBlock
    convs see the nearest-x2 upsample of the block's input, whose absmax is
    the input's own. Yields the dict of 0-d tensors; the hooks go when the
    block ends."""
    records: Dict[str, torch.Tensor] = {}
    handles = []
    for key, path in sites.items():
        def hook(_mod, args, key=key):
            m = args[0].detach().abs().amax().float()
            records[key] = torch.maximum(records[key], m) if key in records else m
        handles.append(module.get_submodule(path).register_forward_pre_hook(hook))
    try:
        yield records
    finally:
        for h in handles:
            h.remove()
