"""The serving kernels as `torch.library` custom ops, namespace `tgsr`.

Importing this module registers every op; nothing else of the port is
needed to load an exported serving program (`engine/aot.py`), and nothing
here imports a model module. Each op is defined beside its kernel's
wrapper, with three implementations:

- CUDA: the wrapper's launch of the hand-written kernel on the current
  stream, which adds one to its count in `_build.LAUNCHES`;
- CPU: the kernel's plain version;
- fake: the exact output shapes and dtypes, for `torch.export` and other
  tracers.

| op | kernel (csrc/) | wrapper |
| --- | --- | --- |
| tgsr::word_pixel_attention | word_pixel_attention.cu | ops/fused_attention.py |
| tgsr::word_pixel_attention_bwd | word_pixel_attention.cu (backward) | ops/fused_attention.py |
| tgsr::up_head | up_head.cu | ops/up_head.py |
| tgsr::up_head_packed | up_head_packed.cu | ops/up_head_packed.py |
| tgsr::glu_requant | glu_requant.cu (GLU + requantize) | ops/glu_requant.py |
| tgsr::requant | glu_requant.cu (requantize) | ops/glu_requant.py |
| tgsr::int8_conv | int8_conv.cu | ops/int8_conv.py |

The conv probe's kernels (`ops/conv_probe.py`) never run in a serving
program and stay on ctypes alone.
"""

from __future__ import annotations

from tgsr_tpu_torch.ops import (fused_attention, glu_requant, int8_conv,  # noqa: F401 (registers)
                                up_head, up_head_packed)

NAMESPACE = "tgsr"
OPS = ("word_pixel_attention", "word_pixel_attention_bwd", "up_head", "up_head_packed",
       "glu_requant", "requant", "int8_conv")
