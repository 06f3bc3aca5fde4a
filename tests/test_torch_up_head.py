"""The fused up-head of tgsr_tpu_torch against tgsr_tpu, f32 on the CPU.

The port's `fused_up_head` (which runs its plain version for CPU tensors)
and `reference_up_head` are held against the JAX Pallas `fused_up_head` in
interpret mode and the JAX `reference_up_head`, on the parametrisation of
tests/test_pallas_up_head.py and at its gate rtol = atol = 1e-4 (two float32
convolutions summed in another order). The CUDA kernel is held against the
plain version on the card in tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.ops import pallas_up_head as jup
from tgsr_tpu_torch.ops.up_head import fold_bn, fused_up_head, reference_up_head

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(b, h, w, cin, c2, head_k, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sd=1.0: (sd * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    x = f(b, h, w, cin)
    w_up = f(3, 3, cin, c2, sd=0.2)
    scale, bias, mean = 1 + f(c2, sd=0.1), f(c2, sd=0.1), f(c2, sd=0.1)
    var = np.abs(1 + f(c2, sd=0.2))
    w_head = f(head_k, head_k, c2 // 2, 3, sd=0.2)
    srb = f(b, 2 * h, 2 * w, 3)
    return x, w_up, (scale, bias, mean, var), w_head, srb


CASES = [
    # (h, w, cin, c2, head_k, tanh, blend, jax tile)
    (16, 16, 64, 64, 3, False, False, 8),
    (16, 16, 64, 64, 5, True, True, 8),
    (8, 8, 32, 64, 3, False, False, 16),  # single tile (th == 2h)
    (12, 12, 16, 32, 5, True, False, 8),  # non-pow2 H
]


@pytest.mark.parametrize("cfg", CASES)
def test_port_matches_jax(cfg):
    h, w, cin, c2, head_k, use_tanh, blend, tile = cfg
    x, w_up, bn, w_head, srb = _inputs(2, h, w, cin, c2, head_k)
    j_mul, j_add = jup.fold_bn(*map(jnp.asarray, bn))
    a = 0.5
    ref_pallas = np.asarray(jup.fused_up_head(
        jnp.asarray(x), jnp.asarray(w_up), j_mul, j_add, jnp.asarray(w_head),
        jnp.asarray(srb), jnp.asarray(a), head_k=head_k, use_tanh=use_tanh,
        blend=blend, tile_rows=tile))
    ref_xla = np.asarray(jup.reference_up_head(
        jnp.asarray(x), jnp.asarray(w_up), j_mul, j_add, jnp.asarray(w_head),
        jnp.asarray(srb), jnp.asarray(a), use_tanh=use_tanh, blend=blend))

    t = [torch.from_numpy(v) for v in (x, w_up, w_head, srb)]
    mul, add = fold_bn(*(torch.from_numpy(v) for v in bn))
    np.testing.assert_allclose(mul.numpy(), np.asarray(j_mul), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(add.numpy(), np.asarray(j_add), rtol=1e-6, atol=1e-6)
    for fn in (fused_up_head, reference_up_head):
        got = fn(t[0], t[1], mul, add, t[2], t[3], torch.tensor(a),
                 use_tanh=use_tanh, blend=blend).numpy()
        assert got.shape == ref_pallas.shape == (2, 2 * h, 2 * w, 3)
        np.testing.assert_allclose(got, ref_pallas, **TOL)
        np.testing.assert_allclose(got, ref_xla, **TOL)


def test_head_padding_is_zero_glu():
    """The head conv pads the GLU output with zeros, not with GLU(bn_add):
    with a zero input and a zero up-conv the interior is the head of the
    constant GLU(bn_add) and the border sees fewer taps."""
    x, w_up, bn, w_head, _ = _inputs(1, 4, 4, 8, 16, 3, seed=3)
    mul, add = fold_bn(*(torch.from_numpy(v) for v in bn))
    y = fused_up_head(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 16), mul,
                      add, torch.from_numpy(w_head)).numpy()
    g = add[:8] * torch.sigmoid(add[8:])  # the constant GLU value
    interior = np.einsum("c,uvco->o", g.numpy(), w_head)
    np.testing.assert_allclose(y[0, 3, 3], interior, rtol=1e-5, atol=1e-6)
    corner = np.einsum("c,uvco->o", g.numpy(), w_head[1:, 1:])
    np.testing.assert_allclose(y[0, 0, 0], corner, rtol=1e-5, atol=1e-6)


def test_wrapper_has_no_path_for_other_devices():
    """CPU tensors take the plain version; any device but CUDA raises."""
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        fused_up_head(m(1, 4, 4, 8), m(3, 3, 8, 16), m(16), m(16), m(3, 3, 8, 3))
