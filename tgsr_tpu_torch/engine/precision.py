"""Compute-dtype casts (counterpart of tgsr_tpu/engine/precision.py).

Serving: `cast_floats`, which the JAX pipeline applies to its generator
trees, casts a module once.

`float32_math` turns TF32 off around the training steps and the DAMSM
ranking, whatever the process's switches say; `pin_float32_math` turns it
off for the whole process, as a float32 `SRPipeline` built on the card does,
and prints `FLOAT32_MATH_NOTE` where that turns a switch off.

Training (`GANTrainer`, JAX's `compute_dtype`, gan_trainer.py:79-84,
261-272): `call_cast` runs a module with its parameters cast at apply time,
as the JAX trainer casts its parameter trees inside the differentiated
function. The casts are autograd ops, so the gradients land in the float32
master parameters; the optimizer state and the EMA are float32 because they
are made from those masters. The BatchNorm running stats are not cast at
all: `ops/blocks.BatchNorm` computes its moments in float32 and blends them
into its float32 buffers, which is the float32 recursion JAX's
`merge_stats` recovers after its cast. Losses run on outputs the caller
casts back to float32. Why casts and not `torch.autocast`: casting the
parameters and the inputs once gives JAX's dataflow, every conv, GLU,
upsample and attention in bfloat16 on bfloat16 weights, on the CPU and the
card alike; autocast decides per op (elementwise ops follow their inputs,
some ops it runs in float32) and its rules differ between the two devices.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Mapping, Optional

import torch
from torch import nn

# the compute dtypes SRPipeline serves and GANTrainer trains in
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


@contextlib.contextmanager
def float32_math() -> Iterator[None]:
    """TF32 off for the block, the switches restored after: cuDNN's
    convolutions (on by PyTorch's default) and cuBLAS's GEMMs round
    float32 operands to TF32's 10-bit mantissa when their switch is on. The
    trainers' and the ranking's float32 is float32, as the JAX package's is
    on the CPU they are held against. Also a decorator. Not thread-safe:
    for single-threaded entry points."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


FLOAT32_MATH_NOTE = ("float32 serving: cuDNN's and cuBLAS's TF32 switched off for this "
                     "process (torch.backends.cudnn.allow_tf32, "
                     "torch.backends.cuda.matmul.allow_tf32)")


def pin_float32_math() -> None:
    """TF32 off for the rest of the process, cuDNN's and cuBLAS's switches
    both. Serving's float32 runs on many threads (BatchingServer's collector,
    the HTTP handlers, the callers of `SRPipeline.lock`), which a switch
    restored at the end of a call would race with. Prints FLOAT32_MATH_NOTE
    in one line where a switch was on (so a process whose TF32 was on by
    PyTorch's default prints it once, at its first float32 pipeline)."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        print(FLOAT32_MATH_NOTE, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def cast_floats(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Casts every floating-point parameter and buffer of `module` in place
    to `dtype`: weights, BN scale and bias, BN running mean and var, the
    blend `a`. Integer buffers (BN's num_batches_tracked) keep their type.
    A no-op for float32. Returns the module."""
    if dtype == torch.float32:
        return module
    return module.to(dtype)  # casts floating-point tensors only


class _Method(nn.Module):
    """`module.<method>` as a module's forward, so that
    `torch.func.functional_call` can swap the parameters of any method."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.m = module
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.method)(*args, **kwargs)


def call_cast(module: nn.Module, dtype: torch.dtype, *args, method: str = "forward",
              overrides: Optional[Mapping[str, torch.Tensor]] = None, buffers: bool = False,
              **kwargs) -> Any:
    """`module.<method>(*args, **kwargs)` with every floating-point parameter
    read as its `dtype` copy for this call (a differentiable cast of the
    float32 master), and `overrides` (name -> tensor, cast likewise) in place
    of the module's own tensors of those names. Buffers are the module's own
    (train-mode BatchNorm updates them in place), or with `buffers` their
    `dtype` copies (eval, as JAX casts its batch_stats). float32 without
    overrides is a plain call."""
    if dtype == torch.float32 and not overrides:
        return getattr(module, method)(*args, **kwargs)
    named = list(module.named_parameters()) + (list(module.named_buffers()) if buffers else [])
    tensors = {f"m.{name}": p.to(dtype) if p.is_floating_point() else p for name, p in named}
    for name, t in (overrides or {}).items():
        tensors[f"m.{name}"] = t.to(dtype)
    # a module bound under several names (the x16 family's tied stage and
    # head) is swapped once, under the one name named_parameters() gives it:
    # with tie_weights=True functional_call also swaps each alias, and its
    # restore puts the alias's "original" (the swapped-in copy) back last
    return torch.func.functional_call(_Method(module, method), tensors, args, kwargs,
                                      tie_weights=False)
