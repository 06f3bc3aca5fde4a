"""The fused up-head of tgsr_tpu_torch against tgsr_tpu, f32 on the CPU.

The port's `fused_up_head` (which runs its plain version for CPU tensors)
and `reference_up_head` are held against the JAX Pallas `fused_up_head` in
interpret mode and the JAX `reference_up_head`, on the parametrisation of
tests/test_pallas_up_head.py and at its gate rtol = atol = 1e-4 (two float32
convolutions summed in another order). The CUDA kernel is held against the
plain version on the card in tests/test_torch_kernels_cuda.py.

The kernel's arithmetic is checked here without a card: `split_tf32` against
an independent float64 rounding (nearest, ties away from zero, as
`cvt.rna.tf32.f32`); an emulation of its 3xTF32 up-conv per parity class on
the combined weights against the Pallas kernel in interpret mode, within the
same 1e-4 gate, with one TF32 product at least 10x worse on the same inputs
and outside the gate;
and `pack_upconv_weight`'s fragment order, read back lane by lane as the
kernel reads it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tgsr_tpu.ops import pallas_up_head as jup
from tgsr_tpu_torch.ops.blocks import nchw
from tgsr_tpu_torch.ops.fused_upsample import fuse_upconv_kernel
from tgsr_tpu_torch.ops.up_head import (fold_bn, fused_up_head, pack_upconv_weight,
                                        prepare_up_head, reference_up_head, split_tf32,
                                        up_head_tail)

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


def _rna_tf32_f64(v: np.ndarray) -> np.ndarray:
    """Independent reference: v rounded to 11 significant bits (TF32's 10
    stored), to nearest, ties away from zero, in float64."""
    m, e = np.frexp(np.abs(v.astype(np.float64)))  # |v| = m 2^e, m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5)
    return (np.sign(v) * np.ldexp(r, e - 11)).astype(np.float32)


def test_split_tf32_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(7)
    v = (rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    # exact ties: the 13 dropped bits are 1 followed by zeros (exponents from
    # 2^-107, so that v - big stays a normal number, as the reference needs)
    ties = rng.integers(20 << 23, 1 << 30, 256).astype(np.uint32) & ~np.uint32(0x1FFF)
    ties = (ties | np.uint32(0x1000)).view(np.float32)
    v = np.concatenate([v, ties, -ties, np.float32([0.0, 1.0, -1.5])])
    big, small = split_tf32(torch.from_numpy(v))
    big, small = big.numpy(), small.numpy()
    np.testing.assert_array_equal(big, _rna_tf32_f64(v))
    np.testing.assert_array_equal(small, _rna_tf32_f64(v - big))
    assert not (big.view(np.uint32) & 0x1FFF).any() and not (small.view(np.uint32) & 0x1FFF).any()
    t = ties[ties < np.float32(1e30)]  # ties round away from zero: up in magnitude
    assert (np.abs(split_tf32(torch.from_numpy(t))[0].numpy()) > np.abs(t)).all()
    rest = np.abs(v.astype(np.float64) - big - small)
    assert (rest <= 2.0 ** -21 * np.abs(v)).all()


def _upconv_tf32(x: torch.Tensor, w_up: torch.Tensor, products: int) -> torch.Tensor:
    """The kernel's up-conv, emulated: per parity class (di, dj) the GEMM
    [H W, 4 Cin] x [4 Cin, C2] on the combined weights, A row (i, j) the
    source pixels (i + di - 1 + m, j + dj - 1 + n) (zero outside), both
    operands split by `split_tf32`, float32 sums of big*big (+ big*small +
    small*big for 3 products). Returns the NCHW conv3x3(up2(x))."""
    b, h, w, cin = x.shape
    c2 = w_up.shape[-1]
    wb = fuse_upconv_kernel(w_up).reshape(2, 2, cin, 4, c2).permute(3, 0, 1, 2, 4)
    wb = wb.reshape(4, 4 * cin, c2)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros(b, 2 * h, 2 * w, c2)
    for di in range(2):
        for dj in range(2):
            a = torch.cat([xp[:, di + m:di + m + h, dj + n:dj + n + w]
                           for m in range(2) for n in range(2)], dim=-1)
            (ab, as_), (bb, bs) = split_tf32(a), split_tf32(wb[2 * di + dj])
            y = ab @ bb
            if products == 3:
                y = y + ab @ bs + as_ @ bb
            out[:, di::2, dj::2] = y
    return nchw(out)


@pytest.mark.parametrize("cfg", CASES)
def test_tf32x3_upconv_matches_jax(cfg):
    """The kernel's 3xTF32 up-conv (emulated), then BN, GLU and the head,
    within 1e-4 of the Pallas kernel in interpret mode; one TF32 product on
    the same inputs misses by at least 10x more and fails the row's gate
    1e-4 * max(1, |ref|max), which is why the kernel takes three."""
    h, w, cin, c2, head_k, use_tanh, blend, tile = cfg
    x, w_up, bn, w_head, srb = _inputs(2, h, w, cin, c2, head_k)
    j_mul, j_add = jup.fold_bn(*map(jnp.asarray, bn))
    ref = np.asarray(jup.fused_up_head(
        jnp.asarray(x), jnp.asarray(w_up), j_mul, j_add, jnp.asarray(w_head),
        jnp.asarray(srb), jnp.asarray(0.5), head_k=head_k, use_tanh=use_tanh,
        blend=blend, tile_rows=tile))
    mul, add = fold_bn(*(torch.from_numpy(v) for v in bn))
    err = {}
    for products in (3, 1):
        hc = _upconv_tf32(torch.from_numpy(x), torch.from_numpy(w_up), products)
        got = up_head_tail(hc, mul, add, torch.from_numpy(w_head), torch.from_numpy(srb),
                           torch.tensor(0.5), use_tanh, blend).numpy()
        err[products] = np.abs(got - ref).max()
        if products == 3:
            np.testing.assert_allclose(got, ref, **TOL)
    gate = 1e-4 * max(1.0, np.abs(ref).max())
    assert err[3] <= gate
    assert err[1] >= 10 * err[3], err
    assert err[1] > gate, (err, gate)  # the gate itself refuses one product


@pytest.mark.parametrize("cin, c2", [(8, 16), (16, 32), (32, 64)])
def test_pack_upconv_weight_fragment_order(cin, c2):
    """Each lane's four floats of k8 step s, n-tile pair q and part p are the
    big (p = 0) or small (p = 1) TF32 parts of the b0, b1 fragments (rows
    8s + t and 8s + t + 4, column g) of n-tiles 2q and 2q + 1 of its class
    and tap's combined weight."""
    w_up = torch.from_numpy(np.random.default_rng(cin).normal(size=(3, 3, cin, c2))
                            .astype(np.float32))
    frag = pack_upconv_weight(w_up)
    assert tuple(frag.shape) == (4, 4, cin // 8, c2 // 16, 2, 32, 4) and frag.is_contiguous()
    comb = fuse_upconv_kernel(w_up)  # [m, n, ci, class * C2 + c]
    for cls in range(4):
        for tap in range(4):
            bmat = comb[tap // 2, tap % 2, :, cls * c2:(cls + 1) * c2]  # [Cin, C2]
            for s in range(cin // 8):
                for q in range(c2 // 16):
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        want = torch.stack([
                            bmat[8 * s + t, 16 * q + g], bmat[8 * s + t + 4, 16 * q + g],
                            bmat[8 * s + t, 16 * q + 8 + g], bmat[8 * s + t + 4, 16 * q + 8 + g]])
                        big, small = split_tf32(want)
                        assert torch.equal(frag[cls, tap, s, q, 0, lane], big)
                        assert torch.equal(frag[cls, tap, s, q, 1, lane], small)
    z = torch.zeros(c2)
    assert torch.equal(prepare_up_head(w_up, z, z, z).w_frag, frag)
    with pytest.raises(ValueError, match="% 8"):
        pack_upconv_weight(torch.zeros(3, 3, 12, 32))
    assert prepare_up_head(torch.zeros(3, 3, 12, 32), z, z, z).w_frag is None
