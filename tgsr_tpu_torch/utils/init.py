"""Weight re-initialisation (counterpart of tgsr_tpu/utils/init.py; =
weights_init, miscc/utils.py:454-464).

`orthogonal_reinit` redraws a module's weights in place from a
`torch.Generator`, by JAX's rules on the matching flax tree: conv and
linear kernels orthogonal on JAX's [fan_in, fan_out] view (an OIHW conv
weight seen as HWIO flattened to [H * W * I, O]; a Linear's [in, out]),
BatchNorm scales N(1, 0.02), the biases of convs, Linears and BatchNorms 0.
Every other tensor (embeddings, recurrent weights, weight maps, running
statistics) stays as it was.
"""

from __future__ import annotations

import torch
from torch import nn


def orthogonal(shape, generator: torch.Generator, scale: float = 1.0) -> torch.Tensor:
    """A [rows, cols] matrix with orthonormal columns (rows >= cols) or rows
    (rows < cols), times `scale`: the QR of a standard normal draw with R's
    diagonal signs folded into Q, as jax.nn.initializers.orthogonal."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q if rows >= cols else q.t()) * scale


def orthogonal_reinit(module: nn.Module, generator: torch.Generator,
                      scale: float = 1.0) -> nn.Module:
    """Redraw `module`'s conv and Linear weights orthogonally, its BatchNorm
    scales N(1, 0.02), and zero their biases, in place; returns `module`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                o, i, kh, kw = m.weight.shape
                q = orthogonal((kh * kw * i, o), generator, scale)
                m.weight.copy_(q.reshape(kh, kw, i, o).permute(3, 2, 0, 1))
            elif isinstance(m, nn.Linear):
                m.weight.copy_(orthogonal(tuple(m.weight.shape[::-1]), generator, scale).t())
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                if m.weight is not None:
                    m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape,
                                                            generator=generator))
            else:
                continue
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return module
