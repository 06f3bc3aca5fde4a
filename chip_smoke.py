"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tgsr_tpu_torch/csrc/ with nvcc
(sm_90a, one nvcc per source, all at once), holds each kernel against its
plain PyTorch version at the shapes of the x8 face-SR serving path (float32,
bfloat16, int8), then drives that path three times (SRPipeline at the face
S8 geometry, full width, seeded weights): in float32, where it must go
through the attention and up-head kernels and agree with the same pipeline
on the CPU (every kernel site there runs its plain version); in bfloat16,
where it must go through the attention and packed up-head kernels and hold
>= 40 dB against that float32 reference; and in int8 (scales calibrated on
the card by the port's calibrate_quant), where it must go through the
attention, int8 conv and GLU-requant kernels, hold >= 40 dB against the same
int8 pipeline on the CPU and stay at or above INT8_PSNR_FLOOR against the
float32 reference. Prints one JSON line of per-kernel numbers, then, as the
last line, {"ok": true, "device": {...}}. Exits non-zero without that line
when there is no CUDA card, when the package is missing, or when any check
fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bfloat16 tensor-core peak
INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
B = 64  # batch of the kernel phases
T, C = 18, 32  # caption slots and attention width of the face S8 path
# uint8 PSNR floor of the int8 SR on the card against the float32 SR on the
# CPU, seeded weights: the CPU's own int8-versus-float32 PSNR, which this
# script prints (45.36 dB on an H100 machine's CPU), less 1 dB (PERF.md)
INT8_PSNR_FLOOR = 44.3
FAILURES: list = []

# one full-width int8 forward's convs, all with a bfloat16 output: (site, H,
# W, Cin, Cout, k, up2, BN, residual, calls per forward); H, W the input's
# size
INT8_CONVS = (
    ("h_net1/im2f_conv", 32, 32, 3, 64, 3, False, False, False, 1),
    ("h_net1/residual_*/conv1", 32, 32, 64, 128, 3, False, True, False, 2),
    ("h_net1/residual_*/conv2", 32, 32, 64, 64, 3, False, True, True, 2),
    ("h_net1/upsample/conv", 32, 32, 64, 64, 3, True, True, False, 1),
    ("img_net1/conv", 64, 64, 32, 3, 3, False, False, False, 1),
    ("h_net2/residual_*/conv1", 64, 64, 64, 128, 3, False, True, False, 2),
    ("h_net2/residual_*/conv2", 64, 64, 64, 64, 3, False, True, True, 2),
    ("h_net2/upsample/conv", 64, 64, 64, 64, 3, True, True, False, 1),
    ("img_net2/conv", 128, 128, 32, 3, 3, False, False, False, 1),
    ("h_net3/residual_*/conv1", 128, 128, 64, 128, 3, False, True, False, 2),
    ("h_net3/residual_*/conv2", 128, 128, 64, 64, 3, False, True, True, 2),
    ("h_net3/upsample/conv", 128, 128, 64, 64, 3, True, True, False, 1),
    ("img_net3/conv", 256, 256, 32, 3, 3, False, False, False, 1),
    ("convin/conv", 32, 32, 3, 64, 3, False, False, False, 1),
    ("residual_*/conv1", 32, 32, 32, 64, 3, False, True, False, 6),
    ("residual_*/conv2", 32, 32, 32, 32, 3, False, True, True, 6),
    ("upscale2x/conv", 32, 32, 32, 64, 3, True, True, False, 1),
    ("conv_output/conv 64", 64, 64, 32, 3, 5, False, False, False, 1),
    ("residual24/conv1", 64, 64, 32, 64, 3, False, True, False, 1),
    ("residual24/conv2", 64, 64, 32, 32, 3, False, True, False, 1),
    ("upscale4x/conv", 64, 64, 32, 64, 3, True, True, False, 1),
    ("conv_output/conv 128", 128, 128, 32, 3, 5, False, False, False, 1),
    ("residual48/conv1", 128, 128, 32, 64, 3, False, True, False, 1),
    ("residual48/conv2", 128, 128, 32, 32, 3, False, True, False, 1),
    ("upscale8x/conv", 128, 128, 32, 64, 3, True, True, False, 1),
    ("conv_output/conv 256", 256, 256, 32, 3, 5, False, False, False, 1),
)
# one int8 forward's GLU+requantize sites: (site, H, W, c, calls per forward)
GLU_SITES = (
    ("h_net1/residual_*", 32, 32, 64, 2), ("h_net2/residual_*", 64, 64, 64, 2),
    ("h_net3/residual_*", 128, 128, 64, 2), ("netgh residual_*", 32, 32, 32, 6),
    ("residual24", 64, 64, 32, 1), ("residual48", 128, 128, 32, 1),
    ("h_net3/upsample -> img_net3", 256, 256, 32, 1),
    ("upscale8x -> conv_output", 256, 256, 32, 1),
)


def check(ok: bool, what: str) -> None:
    print(f"{'PASS' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    """The least time for the work: bytes at the memory rate or operations
    at the peak rate of their type, whichever is larger, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sums(rows, keys=("ms", "plain_ms", "library_ms", "bound_ms", "nbytes", "flops")):
    """Per-site numbers summed over one forward's sites; max of the errors."""
    tot = {k: sum(r[k] for r in rows) for k in keys if k in rows[0]}
    tot["max_abs_err"] = max(r["err"] for r in rows)
    return tot


def attention_phase(torch, rng):
    """The attention kernel against its plain version at the three sites of
    one forward, in float32 and in bfloat16. The bfloat16 kernel is held
    against the plain version in float32 on the same bfloat16 inputs: it
    computes in float32 and rounds each output once, so |err| <= 2^-8 |ref|
    + 1e-5 elementwise."""
    import torch.nn.functional as F

    from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain
    from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention

    lens = rng.integers(1, T + 1, B)
    lens[1] = 0  # one caption with every token padded
    mask = torch.as_tensor(np.arange(T)[None, :] >= lens[:, None], device="cuda")
    words32 = torch.randn(B, T, C, device="cuda")
    out = {}
    for dtype, esize, rate in ((torch.float32, 4, F32_FLOP_PER_S),
                               (torch.bfloat16, 2, BF16_FLOP_PER_S)):
        tag = str(dtype).split(".")[-1]
        words = words32.to(dtype)
        rows = []
        for hw in (32, 64, 128):
            px = torch.randn(B, hw, hw, C, device="cuda").to(dtype)
            ctx_k, attn_k = word_pixel_attention(px, words, mask)
            if dtype == torch.float32:
                ctx_p, attn_p = plain(px, words, mask)
                torch.cuda.synchronize()
                err = max((ctx_k - ctx_p).abs().max().item(), (attn_k - attn_p).abs().max().item())
                check(err <= 1e-4, f"attention kernel == plain at [{B},{hw},{hw},{C}] T {T} "
                                   f"(max abs err {err:.3e} <= 1e-4)")
            else:
                ctx_p, attn_p = plain(px.float(), words.float(), mask)
                torch.cuda.synchronize()
                err = max((ctx_k.float() - ctx_p).abs().max().item(),
                          (attn_k.float() - attn_p).abs().max().item())
                excess = max(((ctx_k.float() - ctx_p).abs() - 2 ** -8 * ctx_p.abs()).max().item(),
                             ((attn_k.float() - attn_p).abs() - 2 ** -8 * attn_p.abs()).max().item())
                check(excess <= 1e-5, f"attention kernel bf16 == plain in f32 on the same "
                                      f"inputs at [{B},{hw},{hw},{C}] T {T} (max abs err "
                                      f"{err:.3e}, |err| - 2^-8 |ref| <= {excess:.2e} <= 1e-5)")
            q, kv = px.reshape(B, hw * hw, C), words
            keep = ~mask[:, None, :]
            ms = cuda_ms(lambda: word_pixel_attention(px, words, mask, return_attn=False))
            p_ms = cuda_ms(lambda: plain(px, words, mask, return_attn=False))
            l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep, scale=1.0))
            n = B * hw * hw
            nbytes = esize * (2 * n * C + B * T * C) + B * T  # pixels in, ctx out, words, mask
            flops = n * (4 * T * C + 5 * T)  # two T x C products + softmax
            bms, by = bound_ms(nbytes, flops, rate)
            print(f"  attention {tag} {hw}x{hw}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"sdpa {l_ms:.4f} ms, bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it reached)",
                  flush=True)
            rows.append(dict(ms=ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bms,
                             nbytes=nbytes, flops=flops, err=err))
        tot = sums(rows)
        tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"), rate)[1]
        out[tag] = tot
    entry = {"name": "word_pixel_attention", "route": "cuda",
             "source": "tgsr_tpu_torch/csrc/word_pixel_attention.cu",
             "replaces": "tgsr_tpu/ops/pallas_attention.py:30", **out["float32"],
             "bfloat16": out["bfloat16"],
             "shapes": f"B {B}, C {C}, T {T}, HW 32^2+64^2+128^2 (one forward's three "
                       "sites); top level float32, 'bfloat16' the bf16 instance"}
    return entry


def up_head_phase(torch):
    """At both up-head sites of one forward (B = 64, 128 -> 256 px): row 2
    (`fused_up_head`, float32) against its plain version; row 3
    (`fused_up_head_packed`) in float32 against its plain version with
    row 2's gate, and in bfloat16 against its plain version on the same
    bfloat16 inputs (float32 sums; a GLU value may round to the neighbouring
    bfloat16: |err| <= 2e-2 * max(1, |ref|max)). Row 2 and row 3 are timed on
    the same float32 inputs."""
    from tgsr_tpu_torch.ops.packed_tail import pack_up_head, packed_up_head
    from tgsr_tpu_torch.ops.up_head import fold_bn, fused_up_head, reference_up_head
    from tgsr_tpu_torch.ops.up_head_packed import fused_up_head_packed

    rows2, rows3 = [], {"float32": [], "bfloat16": []}
    h = w = 128
    for cin, c2, k, use_tanh, blend, site in (
            (64, 64, 3, False, False, "h_net3.upsample+img_net3"),
            (32, 64, 5, True, True, "upscale8x+conv_output+a*srb")):
        x = torch.randn(B, h, w, cin, device="cuda")
        w_up = torch.randn(3, 3, cin, c2, device="cuda") / (9 * cin) ** 0.5
        mul, add = fold_bn(1 + 0.1 * torch.randn(c2, device="cuda"),
                           0.1 * torch.randn(c2, device="cuda"),
                           0.2 * torch.randn(c2, device="cuda"),
                           0.5 + 1.5 * torch.rand(c2, device="cuda"))
        w_head = torch.randn(k, k, c2 // 2, 3, device="cuda") / (k * k * c2 / 2) ** 0.5
        srb = torch.rand(B, 2 * h, 2 * w, 3, device="cuda") * 2 - 1
        a = torch.tensor(0.5, device="cuda")
        args = (x, w_up, mul, add, w_head, srb, a)
        kw = dict(use_tanh=use_tanh, blend=blend)
        ref = reference_up_head(*args, **kw)
        got = fused_up_head(*args, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= 1e-4 * max(1.0, scale),
              f"up-head kernel == plain at {site} [{B},{h},{w},{cin}] C2 {c2} k {k} "
              f"(max abs err {err:.3e}, output max {scale:.3f})")
        ms = cuda_ms(lambda: fused_up_head(*args, **kw), iters=5)
        p_ms = cuda_ms(lambda: reference_up_head(*args, **kw), iters=5)
        n_out = B * 4 * h * w
        # The function's work per output pixel: after a nearest x2 upsample
        # each output parity class sees only 2 x 2 distinct source pixels, so
        # the up-conv needs 4 taps of combined weights (as
        # fused_up_head_packed computes it), not 9; then the k x k head and
        # BN + GLU.
        flops = n_out * (2 * 4 * cin * c2 + 2 * k * k * (c2 // 2) * 3 + 8 * c2)
        # the kernel's own algorithm runs all 9 taps of the up-conv
        issued = n_out * (2 * 9 * cin * c2 + 2 * k * k * (c2 // 2) * 3 + 8 * c2)
        nbytes = 4 * (x.numel() + w_up.numel() + w_head.numel() + 2 * c2
                      + 3 * n_out * (2 if blend else 1))
        bms, by = bound_ms(nbytes, flops)
        print(f"  up-head {site}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it reached), "
              f"{flops / ms / 1e9:.1f} TFLOP/s of the function's work "
              f"({issued / ms / 1e9:.1f} as the kernel issues it, 9 taps)", flush=True)
        rows2.append(dict(ms=ms, plain_ms=p_ms, bound_ms=bms, nbytes=nbytes,
                          flops=flops, err=err))

        for dtype, esize, rate, gate in ((torch.float32, 4, F32_FLOP_PER_S, 1e-4),
                                         (torch.bfloat16, 2, BF16_FLOP_PER_S, 2e-2)):
            tag = str(dtype).split(".")[-1]
            wts = pack_up_head(w_up, mul, add, w_head, dtype=dtype)
            args3 = (x.to(dtype), wts, srb.to(dtype), a.to(dtype))
            ref3 = packed_up_head(*args3, **kw)
            got3 = fused_up_head_packed(*args3, **kw)
            torch.cuda.synchronize()
            err3 = (got3 - ref3).abs().max().item()
            scale3 = ref3.abs().max().item()
            check(err3 <= gate * max(1.0, scale3),
                  f"packed up-head kernel {tag} == plain at {site} (max abs err "
                  f"{err3:.3e} <= {gate:g} * max(1, {scale3:.3f}))")
            ms3 = cuda_ms(lambda: fused_up_head_packed(*args3, **kw), iters=5)
            p_ms3 = cuda_ms(lambda: packed_up_head(*args3, **kw), iters=5)
            nbytes3 = (esize * (x.numel() + wts.w_up.numel() + wts.w_head.numel()
                                + (3 * n_out if blend else 0))
                       + 4 * (2 * c2 + 3 * n_out))  # BN and the image are float32
            bms3, by3 = bound_ms(nbytes3, flops, rate)
            print(f"  packed up-head {tag} {site}: kernel {ms3:.4f} ms, plain {p_ms3:.4f} ms, "
                  f"bound {bms3:.4f} ms ({by3}, {bms3 / ms3:.1%} of it reached), "
                  f"{flops / ms3 / 1e9:.1f} TFLOP/s of the function's work"
                  + (f"; row 2 on the same inputs {ms:.4f} ms" if dtype == torch.float32 else ""),
                  flush=True)
            rows3[tag].append(dict(ms=ms3, plain_ms=p_ms3, bound_ms=bms3, nbytes=nbytes3,
                                   flops=flops, err=err3, up_head_ms=ms))
    row2 = sums(rows2)
    row2["bound_by"] = bound_ms(row2.pop("nbytes"), row2.pop("flops"))[1]
    row3 = {}
    for tag, rate in (("float32", F32_FLOP_PER_S), ("bfloat16", BF16_FLOP_PER_S)):
        row3[tag] = sums(rows3[tag], keys=("ms", "plain_ms", "bound_ms", "nbytes", "flops",
                                           "up_head_ms"))
        row3[tag]["bound_by"] = bound_ms(row3[tag].pop("nbytes"), row3[tag].pop("flops"), rate)[1]
        row3[tag]["library_ms"] = None
    shapes = f"B {B}, 128->256 px, both sites of one forward"
    return [{"name": "up_head", "route": "cuda", "source": "tgsr_tpu_torch/csrc/up_head.cu",
             "replaces": "tgsr_tpu/ops/pallas_up_head.py:78", **row2, "library_ms": None,
             "shapes": shapes + ", float32"},
            {"name": "up_head_packed", "route": "cuda",
             "source": "tgsr_tpu_torch/csrc/up_head_packed.cu",
             "replaces": "tgsr_tpu/ops/pallas_up_head.py:244", **row3["bfloat16"],
             "float32": row3["float32"],
             "shapes": shapes + "; top level bfloat16 (the main path's), 'float32' "
                                "the f32 instance, up_head_ms row 2 on the same inputs"}]


def int8_conv_phase(torch):
    """`int8_conv` against its plain version (float64 convolution on the
    int8 values, exact) at every conv shape of one full-width B = 64 int8
    forward: the int32 sums and the float32 epilogue bit for bit, the
    bfloat16 output within one bfloat16 ulp. Times are summed over the
    forward's calls (weighted by calls per forward)."""
    import torch.nn.functional as F

    from tgsr_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain, pack_int8_weight

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for site, h, w, cin, cout, k, up2, bn, res, n in INT8_CONVS:
        ho, wo = (2 * h, 2 * w) if up2 else (h, w)
        x = torch.randint(-127, 128, (B, h, w, cin), generator=g, device="cuda",
                          dtype=torch.int8)
        wt = pack_int8_weight(torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                                            device="cuda", dtype=torch.int8))
        scale = torch.rand(cout, generator=g, device="cuda") * 1e-5 + 1e-6
        affine = ((1 + 0.1 * torch.randn(cout, generator=g, device="cuda"),
                   0.1 * torch.randn(cout, generator=g, device="cuda")) if bn else None)
        resid = (torch.randn(B, ho, wo, cout, generator=g, device="cuda").bfloat16()
                 if res else None)
        # the int32 sums, through a float32 output with scale 1 (exact: |sum| < 2^24)
        one = torch.ones(cout, device="cuda")
        acc_k = int8_conv(x, wt, one, out_dtype=torch.float32, up2=up2)
        acc_p = int8_conv_plain(x, wt, one, out_dtype=torch.float32, up2=up2)
        f32_k = int8_conv(x, wt, scale, bn=affine, out_dtype=torch.float32, up2=up2)
        f32_p = int8_conv_plain(x, wt, scale, bn=affine, out_dtype=torch.float32, up2=up2)
        args = (x, wt, scale, affine, resid, torch.bfloat16, up2)
        got, ref = int8_conv(*args), int8_conv_plain(*args)
        torch.cuda.synchronize()
        exact = torch.equal(acc_k, acc_p) and torch.equal(f32_k, f32_p)
        ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
        ulps = ((got.float() - ref.float()).abs() / ulp).max().item()
        err = (got.float() - ref.float()).abs().max().item()
        check(exact and ulps <= 1, f"int8_conv == plain at {site} [{B},{h},{w},{cin}]->{cout} "
                                   f"k{k}{' up2' if up2 else ''}: int32 sums and f32 epilogue "
                                   f"{'equal' if exact else 'DIFFER'}, bf16 {ulps:.2f} ulp <= 1")
        del acc_k, acc_p, f32_k, f32_p, got, ref
        ms = cuda_ms(lambda: int8_conv(*args), iters=5)
        p_ms = cuda_ms(lambda: int8_conv_plain(*args), iters=2, warmup=1)
        xb = x.permute(0, 3, 1, 2).bfloat16().contiguous(memory_format=torch.channels_last)
        if up2:
            xb = F.interpolate(xb, scale_factor=2, mode="nearest")
        wb = torch.randn(cout, cin, k, k, device="cuda").bfloat16().contiguous(
            memory_format=torch.channels_last)
        c_ms = cuda_ms(lambda: F.conv2d(xb, wb, padding=k // 2), iters=5)
        del xb, wb
        nbytes = (x.numel() + k * k * cin * cout + 4 * cout * (3 if bn else 1)
                  + B * ho * wo * cout * (2 + (2 if res else 0)))  # bf16 out [+ residual]
        ops = 2 * B * ho * wo * cout * k * k * cin
        bms, by = bound_ms(nbytes, ops, INT8_OP_PER_S)
        print(f"  int8_conv {site} x{n}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, cuDNN bf16 "
              f"conv (for scale, not the same function) {c_ms:.4f} ms, bound {bms:.4f} ms "
              f"({by}, {bms / ms:.1%} of it reached), {ops / ms / 1e9:.1f} TOP/s", flush=True)
        rows.append(dict(ms=n * ms, plain_ms=n * p_ms, cudnn_bf16_ms=n * c_ms, bound_ms=n * bms,
                         nbytes=n * nbytes, flops=n * ops, err=err))
    tot = sums(rows, keys=("ms", "plain_ms", "cudnn_bf16_ms", "bound_ms", "nbytes", "flops"))
    tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"), INT8_OP_PER_S)[1]
    return {"name": "int8_conv", "route": "cuda", "source": "tgsr_tpu_torch/csrc/int8_conv.cu",
            "replaces": "tgsr_tpu/engine/quant.py:164 (XLA int8 conv; no Pallas kernel)",
            **tot, "library_ms": None,
            "shapes": f"B {B}, the 42 convs of one int8 forward (26 shapes); cudnn_bf16_ms is "
                      "cuDNN's bf16 conv on the same shapes, for scale, not the same function"}


def glu_requant_phase(torch):
    """Both `glu_requant` instances against their plain version at one int8
    forward's sites (B = 64): int8 equal except one step in at most 0.1 %
    of the elements (a gate or product on a bfloat16 rounding boundary)."""
    from tgsr_tpu_torch.ops.glu_requant import INSTANCES, glu_requant, glu_requant_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {name: [] for name in INSTANCES.values()}
    for site, h, w, c, n in GLU_SITES:
        x = (1.5 * torch.randn(B, h, w, 2 * c, generator=g, device="cuda")).bfloat16()
        scale = 2.0
        got, ref = glu_requant(x, scale), glu_requant_plain(x, scale)
        torch.cuda.synchronize()
        d = (got.int() - ref.int()).abs()
        dmax, frac = d.max().item(), (d > 0).double().mean().item()
        name = INSTANCES[c]
        check(dmax <= 1 and frac <= 1e-3, f"{name} == plain at {site} [{B},{h},{w},{2 * c}] "
                                          f"(max {dmax} step, {frac:.2e} of elements differ)")
        ms = cuda_ms(lambda: glu_requant(x, scale), iters=10)
        p_ms = cuda_ms(lambda: glu_requant_plain(x, scale), iters=5)
        nbytes = x.numel() * 2 + x.numel() // 2  # bf16 in, int8 out
        ops = 10 * (x.numel() // 2)  # sigmoid, product, divide, clip, round per output
        bms, by = bound_ms(nbytes, ops)
        print(f"  {name} {site} x{n}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}, {bms / ms:.1%} of it reached)", flush=True)
        rows[name].append(dict(ms=n * ms, plain_ms=n * p_ms, bound_ms=n * bms,
                               nbytes=n * nbytes, flops=n * ops, err=float(dmax)))
    out = []
    for (line, c), name in zip(((72, 64), (96, 32)), ("glu_requant_one", "glu_requant_pair")):
        tot = sums(rows[name])
        tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"))[1]
        out.append({"name": name, "route": "cuda", "source": "tgsr_tpu_torch/csrc/glu_requant.cu",
                    "replaces": f"examples/glu_pallas_probe.py:{line}", **tot,
                    "library_ms": None,
                    "shapes": f"B {B}, c {c}, the sites of one int8 forward; max_abs_err in "
                              "int8 steps"})
    return out


def psnr_u8(a, b) -> float:
    """uint8 PSNR of two [-1, 1] float images (tensors on any device)."""
    from tgsr_tpu_torch.engine.inference import to_uint8

    d = to_uint8(a.float().cpu()).double() - to_uint8(b.float().cpu()).double()
    return 10 * np.log10(255.0 ** 2 / max(d.square().mean().item(), 1e-12))


def pipeline_phase(torch, rng, card):
    """Drives the main path in float32, bfloat16 and int8, each with the
    launch counts set to 0 just before and read just after; returns those
    counts."""
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.ops import _build

    cfg = face_s8_config()
    vocab = 41
    sds = init_seeded(cfg, vocab, torch.Generator().manual_seed(0))
    # the reference: the same weights on the CPU in float32, where every
    # kernel site runs its plain version
    plain = SRPipeline(cfg, vocab, *sds, device="cpu")

    def batch(n):
        lr = rng.integers(0, 256, (n, 32, 32, 3)).astype("uint8")
        lens = rng.integers(1, T + 1, n)
        lens[min(1, n - 1)] = 0  # an empty caption
        cap = rng.integers(1, vocab, (n, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        return lr, cap, lens

    lr8, cap8, lens8 = batch(8)
    lr8f = lr8.astype("float32") / 127.5 - 1.0
    t0 = time.perf_counter()
    ref = plain(lr8f, cap8, lens8)["sr"]
    print(f"  plain reference on the CPU, B=8: {time.perf_counter() - t0:.1f} s", flush=True)
    del plain
    n, mb = 100, 64
    lr, cap, lens = batch(n)
    lrc, capc, lensc = batch(16)  # int8 calibration batch
    launches, scales = {}, None
    zero = {name: 0 for name in _build.LAUNCH_NAMES}
    for tag in ("float32", "bfloat16", "int8"):
        f32 = tag == "float32"
        per_forward = dict(zero, word_pixel_attention=3)
        per_forward.update({"float32": {"up_head": 2}, "bfloat16": {"up_head_packed": 2},
                            "int8": {"int8_conv": 42, "glu_requant_one": 6,
                                     "glu_requant_pair": 10}}[tag])
        kw = dict(compute_dtype=torch.float32 if f32 else torch.bfloat16)
        if tag == "int8":
            kw["quant_scales"] = scales
        kern = SRPipeline(cfg, vocab, *sds, device="cuda", **kw)
        _build.reset_launches()
        got = kern(lr8f, cap8, lens8)["sr"]
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        check(counts == per_forward, f"one {tag} forward launches {per_forward} ({counts})")
        check(tuple(got.shape) == (8, 256, 256, 3) and got.dtype == torch.float32
              and bool(torch.isfinite(got).all()),
              f"{tag} SR is finite float32, shape {tuple(got.shape)}")
        du8 = (to_uint8(got).cpu().int() - to_uint8(ref).int()).abs()
        one = kern(lr8f[:1], cap8[:1], lens8[:1])["sr"]
        d1 = (to_uint8(one[0]).int() - to_uint8(got[0]).int()).abs().max().item()
        if f32:
            err = (got.cpu() - ref).abs().max().item()
            check(err <= 1e-3, f"SR of the card's kernels == plain on the CPU, f32 "
                               f"(max abs err {err:.3e} <= 1e-3)")
            check(du8.max().item() <= 1, f"uint8 SR kernels vs plain differ by at most 1 "
                                         f"(max {du8.max().item()})")
            err1 = (one[0] - got[0]).abs().max().item()
            check(err1 <= 1e-4, f"row 0 of the mixed-length batch == its B=1 result "
                                f"(max abs err {err1:.3e} <= 1e-4)")
        elif tag == "bfloat16":
            psnr = psnr_u8(got, ref)
            check(psnr >= 40, f"uint8 SR bf16 on the card vs f32 plain on the CPU: "
                              f"PSNR {psnr:.2f} dB >= 40 (max {du8.max().item()} levels)")
            check(d1 <= 2, f"row 0 of the mixed-length batch within 2 uint8 levels of "
                           f"its B=1 result, bf16 (max {d1})")
        else:
            # the same int8 pipeline and scales on the CPU, every kernel site plain
            cpu = SRPipeline(cfg, vocab, *sds, device="cpu", **kw)
            t0 = time.perf_counter()
            cref = cpu(lr8f[:4], cap8[:4], lens8[:4])["sr"]
            print(f"  int8 plain reference on the CPU, B=4: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            del cpu
            psnr_cpu = psnr_u8(got[:4], cref)
            check(psnr_cpu >= 40, f"uint8 SR int8 on the card vs int8 plain on the CPU, same "
                                  f"scales: PSNR {psnr_cpu:.2f} dB >= 40")
            floor_cpu = psnr_u8(cref, ref[:4])
            psnr = psnr_u8(got, ref)
            print(f"  int8 vs f32, both on the CPU (B=4): uint8 PSNR {floor_cpu:.2f} dB",
                  flush=True)
            check(psnr >= INT8_PSNR_FLOOR, f"uint8 SR int8 on the card vs f32 plain on the "
                                           f"CPU: PSNR {psnr:.2f} dB >= {INT8_PSNR_FLOOR}")
            check(d1 <= 2, f"row 0 of the mixed-length batch within 2 uint8 levels of "
                           f"its B=1 result, int8 (max {d1})")
        check(float(got.std()) > 1e-3, f"{tag} SR is not constant (std {float(got.std()):.4f})")

        kern.sr_batched(lr, cap, lens, microbatch=mb)  # warm-up at the same shapes
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = kern.sr_batched(lr, cap, lens, microbatch=mb)
        dt = time.perf_counter() - t0
        launches[tag] = dict(_build.LAUNCHES)
        m = -(-n // mb)
        want = {key: v * m for key, v in per_forward.items()}
        check(launches[tag] == want,
              f"sr_batched {tag} N={n} microbatch {mb}: {m} forwards went through the "
              f"kernels ({launches[tag]})")
        check(out.shape == (n, 256, 256, 3) and out.dtype.name == "uint8" and out.std() > 1,
              f"sr_batched {tag} output uint8 {out.shape}")
        print(f"  sr_batched {tag} N={n} microbatch {mb}: {dt:.4f} s, {n / dt:.2f} img/s "
              f"(seeded weights) on {card}", flush=True)
        profile_forward(torch, kern, lr[None, :mb], cap[None, :mb], lens[None, :mb], tag)
        if tag == "bfloat16":
            t0 = time.perf_counter()
            scales = kern.calibrate_quant(lrc.astype("float32") / 127.5 - 1.0, capc, lensc)
            print(f"  calibrate_quant on the card, B=16: {time.perf_counter() - t0:.1f} s, "
                  f"{sum(len(v) for v in scales.values())} scales", flush=True)
        del kern
    return launches


def profile_forward(torch, pipe, lr, cap, lens, tag: str, top: int = 12) -> None:
    """Device time of one B=64 forward by kernel (torch.profiler, CUPTI),
    and the share of cuDNN's layout conversions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.forward_scan(lr, cap, lens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("  profile: no device time recorded (not measured)", flush=True)
        return
    print(f"  profile of one {tag} forward at B={lr.shape[1]}: device {dev:.3f} ms, "
          f"wall {wall:.3f} ms under the profiler, idle share "
          f"{max(0.0, 1 - dev / wall):.3f}", flush=True)
    conv = [e for e in events if "nchwToNhwc" in e.key or "nhwcToNchw" in e.key]
    conv_ms = sum(e.self_device_time_total for e in conv) / 1e3
    print(f"    layout conversions: {sum(e.count for e in conv)} launches, "
          f"{conv_ms:.3f} ms, {conv_ms / dev:.1%}", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:9.3f} ms {ms / dev:6.1%} x{e.count:<4d} {e.key[:90]}", flush=True)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    try:
        from tgsr_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the tgsr_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    secs = _build.build()
    print(f"built kernels {list(_build.KERNELS)} in {secs:.1f} s", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    t0 = time.perf_counter()
    kernels = [attention_phase(torch, rng), *up_head_phase(torch), *glu_requant_phase(torch),
               int8_conv_phase(torch)]
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = pipeline_phase(torch, rng, card)
    print(f"pipeline phases: {time.perf_counter() - t0:.1f} s", flush=True)
    # launches: the main path's runs, f32, bf16 and int8 (counted apart per
    # path; "launches" is their sum)
    for k in kernels:
        k["launches"] = sum(run[k["name"]] for run in launches.values())
        k["launches_by_path"] = {tag: run[k["name"]] for tag, run in launches.items()}
        for tag in ("float32", "bfloat16"):
            if tag in k:
                k[tag]["launches"] = launches[tag][k["name"]]
        check(k["launches"] > 0, f"{k['name']} launched on the main path")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
