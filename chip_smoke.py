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
attention, int8 conv, GLU-requant and requant kernels, hold >= 40 dB against
the same int8 pipeline on the CPU and stay at or above INT8_PSNR_FLOOR
against the float32 reference. Then drives the conv probe path
(tgsr_tpu_torch.probes.conv_probe at B = 64, 128 x 128 px), whose four
tensor-core kernels (tap9, im2col, pair5 and dotceil, all on wgmma with
TMA-fed operands) are first held against their plain versions within one
bfloat16 ulp, and none of which may spill registers. Prints one JSON line of
per-kernel numbers, then, as the last line, {"ok": true, "device": {...}}.
Exits non-zero without that line when there is no CUDA card, when the
package is missing, or when any check fails.
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
TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak
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
# the int8 convs whose input arrives as int8 from a GLU-requant (the ResBlock
# conv2s, and the heads after a head-feeding UpBlock); every other conv's
# bfloat16 input is requantized by `requant` (X2): (site, H, W, Cin, calls
# per forward), 26 calls
GLU_FED = ("conv2", "img_net3/conv", "conv_output/conv 256")
REQUANT_SITES = tuple((site, h, w, cin, n) for site, h, w, cin, _, _, _, _, _, n in INT8_CONVS
                      if not any(f in site for f in GLU_FED))
# int8 steps of the exhaustive requant check: a power of two (exact ties), a
# calibrated-looking one, and one where a multiply by 1 / step without the
# kernel's guard misrounds
REQUANT_SCALES = (127.0 / 64, 3.0, 14.741072019324145)
# one int8 forward's GLU+requantize sites: (site, H, W, c, calls per forward)
GLU_SITES = (
    ("h_net1/residual_*", 32, 32, 64, 2), ("h_net2/residual_*", 64, 64, 64, 2),
    ("h_net3/residual_*", 128, 128, 64, 2), ("netgh residual_*", 32, 32, 32, 6),
    ("residual24", 64, 64, 32, 1), ("residual48", 128, 128, 32, 1),
    ("h_net3/upsample -> img_net3", 256, 256, 32, 1),
    ("upscale8x -> conv_output", 256, 256, 32, 1),
)
# the conv probe's kernels: (formulation, line of its TPU function in
# examples/pallas_conv_probe.py)
CONV_PROBE = (("tap9", 85), ("im2col", 132), ("pair5", 172), ("dotceil", 196))


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


def cuda_ms_median(fn, repeats: int = 5, iters: int = 20) -> float:
    """The median of `repeats` cuda_ms means: the same per-call time, but a
    host stall of a few ms inside one 20-call mean (seen at the small
    GLU-requant sites) moves it no more than a fifth of the time."""
    return float(np.median([cuda_ms(fn, iters=iters) for _ in range(repeats)]))


def device_ms(torch, fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls with the
    host's launch gaps hidden: the calls are queued behind a spin kernel
    (`torch.cuda._sleep`) that keeps the card busy until all of them are
    enqueued, so the CUDA events time the card's work alone. For calls
    shorter than the host needs to launch them, where cuda_ms times the
    host. Raises if the card reached the calls before they were queued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # tens of ms at the card's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if start.query():
        raise RuntimeError("device_ms: the card reached the calls before the host queued them")
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    """The least time for the work: bytes at the memory rate or operations
    at the peak rate of their type, whichever is larger, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def packed_tc_issued_flops(b: int, h: int, w: int, cin: int, c2: int) -> float:
    """Operations the bfloat16 packed up-head kernel issues on the tensor
    cores (csrc/up_head_packed.cu): per 8 x 16 packed tile and parity class,
    the up-conv over 192 rows (180 GLU positions, in 12 m16 tiles) x 4 taps x
    Cin (rounded up to 16) x C2, and the head over 128 packed pixels x 9 taps
    x C (rounded up to 16) x 16 (12 outputs)."""
    tiles = b * -(-h // 8) * -(-w // 16)
    kp, cp = -(-cin // 16) * 16, -(-(c2 // 2) // 16) * 16
    return 2.0 * tiles * 4 * (192 * 4 * kp * c2 + 128 * 9 * cp * 16)


def finite_bf16(torch):
    """Every finite bfloat16 (65,280 bit patterns) on the card."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]
    return torch.from_numpy((bits << 16).view(np.float32)).bfloat16().cuda()


def copy_floor_ms(torch, x, word):
    """The memory floor of a pass that reads x (bfloat16) and writes a
    quarter (GLU, word int64) or half (requant, word int32) of its bytes:
    one PyTorch elementwise cast over the same storage, each `word` of x
    narrowed to an int16, the same bytes in and out with no arithmetic. Not
    the same function; timed for the floor, used nowhere in the port."""
    src = x.reshape(-1).view(word)
    return cuda_ms_median(lambda: src.to(torch.int16))


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
            # 50 calls: at the small sites each call takes the host longer than
            # the card, and one slow launch would move a mean of 10
            ms = cuda_ms(lambda: word_pixel_attention(px, words, mask, return_attn=False),
                         iters=50, warmup=5)
            d_ms = device_ms(torch, lambda: word_pixel_attention(px, words, mask,
                                                                 return_attn=False), iters=20)
            p_ms = cuda_ms(lambda: plain(px, words, mask, return_attn=False))
            l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep, scale=1.0))
            n = B * hw * hw
            nbytes = esize * (2 * n * C + B * T * C) + B * T  # pixels in, ctx out, words, mask
            flops = n * (4 * T * C + 5 * T)  # two T x C products + softmax
            bms, by = bound_ms(nbytes, flops, rate)
            print(f"  attention {tag} {hw}x{hw}: kernel {ms:.4f} ms (device time {d_ms:.4f}), "
                  f"plain {p_ms:.4f} ms, "
                  f"sdpa {l_ms:.4f} ms, bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it reached)",
                  flush=True)
            rows.append(dict(ms=ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bms,
                             nbytes=nbytes, flops=flops, err=err))
        tot = sums(rows, keys=("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "nbytes",
                               "flops"))
        tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"), rate)[1]
        out[tag] = tot
    entry = {"name": "word_pixel_attention", "route": "cuda",
             "source": "tgsr_tpu_torch/csrc/word_pixel_attention.cu",
             "replaces": "tgsr_tpu/ops/pallas_attention.py:30", **out["float32"],
             "bfloat16": out["bfloat16"],
             "shapes": f"B {B}, C {C}, T {T}, HW 32^2+64^2+128^2 (one forward's three "
                       "sites); top level float32, 'bfloat16' the bf16 instance; ms by CUDA "
                       "events, device_ms with the host's launches queued behind a spin "
                       "kernel (the small sites take less than the host's launch)"}
    return entry


def up_head_phase(torch):
    """At both up-head sites of one forward (B = 64, 128 -> 256 px): row 2
    (`fused_up_head`, float32, 3xTF32 on the tensor cores, the combined
    weight made once as the main path makes it) against its plain version
    within 1e-4 * max(1, |ref|max); row 3
    (`fused_up_head_packed`) in float32 (CUDA cores) against its plain
    version with row 2's gate, and in bfloat16 (tensor cores, its weights in
    fragment order made once as the main path makes them) against its plain
    version on the same bfloat16 inputs (float32 sums; a GLU value may round
    to the neighbouring bfloat16: |err| <= 2e-2 * max(1, |ref|max)). Row 2
    and row 3 are timed on the same float32 inputs."""
    from tgsr_tpu_torch.ops.packed_tail import packed_up_head
    from tgsr_tpu_torch.ops.up_head import (fold_bn, prepare_up_head, reference_up_head,
                                            up_head_folded)
    from tgsr_tpu_torch.ops.up_head_packed import fused_up_head_packed, prepare_up_head_packed

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
        wts = prepare_up_head(w_up, mul, add, w_head)
        ref = reference_up_head(*args, **kw)
        got = up_head_folded(wts, x, srb, a, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= 1e-4 * max(1.0, scale),
              f"up-head kernel == plain at {site} [{B},{h},{w},{cin}] C2 {c2} k {k} "
              f"(max abs err {err:.3e}, output max {scale:.3f})")
        ms = cuda_ms(lambda: up_head_folded(wts, x, srb, a, **kw), iters=5)
        p_ms = cuda_ms(lambda: reference_up_head(*args, **kw), iters=5)
        n_out = B * 4 * h * w
        # The function's work per output pixel: after a nearest x2 upsample
        # each output parity class sees only 2 x 2 distinct source pixels, so
        # the up-conv needs 4 taps of combined weights, not 9; then the k x k
        # head and BN + GLU.
        up_flops = n_out * 2 * 4 * cin * c2
        rest_flops = n_out * (2 * k * k * (c2 // 2) * 3 + 8 * c2)
        flops = up_flops + rest_flops
        nbytes = 4 * (x.numel() + w_up.numel() + w_head.numel() + 2 * c2
                      + 3 * n_out * (2 if blend else 1))
        # the least time at float32 accuracy: the up-conv as three TF32
        # products on the tensor cores, the rest on the CUDA cores; beside it
        # the CUDA-core bound of the first kernel (all of it at 67 TFLOP/s)
        t_ops = 3 * up_flops / TF32_FLOP_PER_S + rest_flops / F32_FLOP_PER_S
        bms = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= t_ops else "operations"
        bms_cc = bound_ms(nbytes, flops)[0]
        print(f"  up-head {site}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"3xTF32 bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it reached; "
              f"CUDA-core bound {bms_cc:.4f} ms), {flops / ms / 1e9:.1f} TFLOP/s of the "
              f"function's work ({(3 * up_flops + rest_flops) / ms / 1e9:.1f} as issued, "
              f"3 TF32 products)", flush=True)
        rows2.append(dict(ms=ms, plain_ms=p_ms, bound_ms=bms, bound_ms_cuda_cores=bms_cc,
                          nbytes=nbytes, flops=flops, err=err))

        for dtype, esize, rate, gate in ((torch.float32, 4, F32_FLOP_PER_S, 1e-4),
                                         (torch.bfloat16, 2, BF16_FLOP_PER_S, 2e-2)):
            tag = str(dtype).split(".")[-1]
            # as the main path: packed once (bfloat16: fragment order too)
            wts = prepare_up_head_packed(w_up, mul, add, w_head, dtype=dtype)
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
            f32 = dtype == torch.float32
            issued = flops if f32 else packed_tc_issued_flops(B, h, w, cin, c2)
            print(f"  packed up-head {tag} {site}: kernel {ms3:.4f} ms, plain {p_ms3:.4f} ms, "
                  f"bound {bms3:.4f} ms ({by3}, {bms3 / ms3:.1%} of it reached), "
                  f"{flops / ms3 / 1e9:.1f} TFLOP/s of the function's work"
                  + (f"; row 2 on the same inputs {ms:.4f} ms" if f32 else
                     f", {issued / ms3 / 1e9:.1f} TFLOP/s as issued on the tensor cores "
                     f"({issued / flops:.2f}x the work: GLU halo, K and N padding)"),
                  flush=True)
            rows3[tag].append(dict(ms=ms3, plain_ms=p_ms3, bound_ms=bms3, nbytes=nbytes3,
                                   flops=flops, issued=issued, err=err3, up_head_ms=ms))
    row2 = sums(rows2, keys=("ms", "plain_ms", "bound_ms", "bound_ms_cuda_cores", "nbytes",
                             "flops"))
    t_bytes = row2.pop("nbytes") / HBM_BYTES_PER_S * 1e3
    row2["bound_by"] = "bytes" if t_bytes >= row2["bound_ms"] else "operations"
    row2.pop("flops")
    row3 = {}
    for tag, rate in (("float32", F32_FLOP_PER_S), ("bfloat16", BF16_FLOP_PER_S)):
        row3[tag] = sums(rows3[tag], keys=("ms", "plain_ms", "bound_ms", "nbytes", "flops",
                                           "issued", "up_head_ms"))
        row3[tag]["tflops_issued"] = row3[tag].pop("issued") / row3[tag]["ms"] / 1e9
        row3[tag]["bound_by"] = bound_ms(row3[tag].pop("nbytes"), row3[tag].pop("flops"), rate)[1]
        row3[tag]["library_ms"] = None
    shapes = f"B {B}, 128->256 px, both sites of one forward"
    return [{"name": "up_head", "route": "cuda", "source": "tgsr_tpu_torch/csrc/up_head.cu",
             "replaces": "tgsr_tpu/ops/pallas_up_head.py:78", **row2, "library_ms": None,
             "shapes": shapes + ", float32; bound_ms at float32 accuracy (up-conv as 3 TF32 "
                                "products at 495 TFLOP/s, head/BN/GLU at 67), "
                                "bound_ms_cuda_cores all at 67"},
            {"name": "up_head_packed", "route": "cuda",
             "source": "tgsr_tpu_torch/csrc/up_head_packed.cu",
             "replaces": "tgsr_tpu/ops/pallas_up_head.py:244", **row3["bfloat16"],
             "float32": row3["float32"],
             "shapes": shapes + "; top level bfloat16 (the main path's, tensor cores; "
                                "tflops_issued counts the products the kernel issues, "
                                "halo and padding included), 'float32' the f32 instance "
                                "(CUDA cores), up_head_ms row 2 on the same inputs"}]


def int8_conv_phase(torch):
    """`int8_conv` against its plain version (float64 convolution on the
    int8 values, exact) at every conv shape of one full-width B = 64 int8
    forward: the int32 sums and the float32 epilogue bit for bit, the
    bfloat16 output within one bfloat16 ulp. Times are summed over the
    forward's calls (weighted by calls per forward). `ms`, `plain_ms` and
    `cudnn_bf16_ms` are CUDA-event times of back-to-back calls (`cuda_ms`),
    as for every other kernel; `device_ms` and `cudnn_bf16_device_ms` are the
    same calls with the host's launch gaps hidden (`device_ms`: many of these
    convs take tens of microseconds, less than the host needs to launch
    them back to back)."""
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
        d_ms = device_ms(torch, lambda: int8_conv(*args))
        p_ms = cuda_ms(lambda: int8_conv_plain(*args), iters=2, warmup=1)
        xb = x.permute(0, 3, 1, 2).bfloat16().contiguous(memory_format=torch.channels_last)
        if up2:
            xb = F.interpolate(xb, scale_factor=2, mode="nearest")
        wb = torch.randn(cout, cin, k, k, device="cuda").bfloat16().contiguous(
            memory_format=torch.channels_last)
        conv = lambda: F.conv2d(xb, wb, padding=k // 2)  # noqa: E731
        c_ms, cd_ms = cuda_ms(conv, iters=5), device_ms(torch, conv)
        del xb, wb
        nbytes = (x.numel() + k * k * cin * cout + 4 * cout * (3 if bn else 1)
                  + B * ho * wo * cout * (2 + (2 if res else 0)))  # bf16 out [+ residual]
        ops = 2 * B * ho * wo * cout * k * k * cin
        bms, by = bound_ms(nbytes, ops, INT8_OP_PER_S)
        print(f"  int8_conv {site} x{n}: kernel {ms:.4f} ms (device time {d_ms:.4f}), plain "
              f"{p_ms:.4f} ms, cuDNN bf16 conv (for scale, not the same function) {c_ms:.4f} ms "
              f"(device time {cd_ms:.4f}), bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it "
              f"reached, {bms / d_ms:.1%} by device time), {ops / ms / 1e9:.1f} TOP/s "
              f"({ops / d_ms / 1e9:.1f} by device time)", flush=True)
        rows.append(dict(ms=n * ms, device_ms=n * d_ms, plain_ms=n * p_ms, cudnn_bf16_ms=n * c_ms,
                         cudnn_bf16_device_ms=n * cd_ms, bound_ms=n * bms, nbytes=n * nbytes,
                         flops=n * ops, err=err))
    tot = sums(rows, keys=("ms", "device_ms", "plain_ms", "cudnn_bf16_ms", "cudnn_bf16_device_ms",
                           "bound_ms", "nbytes", "flops"))
    tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"), INT8_OP_PER_S)[1]
    return {"name": "int8_conv", "route": "cuda", "source": "tgsr_tpu_torch/csrc/int8_conv.cu",
            "replaces": "tgsr_tpu/engine/quant.py:164 (XLA int8 conv; no Pallas kernel)",
            **tot, "library_ms": None,
            "shapes": f"B {B}, the 42 convs of one int8 forward (26 shapes); ms, plain_ms and "
                      "cudnn_bf16_ms by CUDA events, device_ms and cudnn_bf16_device_ms by "
                      "CUDA events with the host's launches queued behind a spin kernel; "
                      "cudnn_bf16_* is cuDNN's bf16 conv on the same shapes, "
                      "for scale, not the same function"}


def glu_requant_phase(torch):
    """Both `glu_requant` instances against their plain version, first over
    every finite bfloat16 gate (against four values) and every finite
    bfloat16 value (against four gates), then at one int8 forward's sites
    (B = 64): int8 equal except one step in at most 0.1 % of the elements (a
    gate or product on a bfloat16 rounding boundary). `ms`, `plain_ms` and
    `copy_floor_ms` (the same bytes through one PyTorch cast) by CUDA
    events, the median of five means (`cuda_ms_median`); `device_ms` with
    the host's launches queued behind a spin kernel (the small sites take
    less than the host's launch)."""
    from tgsr_tpu_torch.ops.glu_requant import INSTANCES, glu_requant, glu_requant_plain

    every = finite_bf16(torch)
    for c, name in sorted(INSTANCES.items()):
        grid = every.reshape(-1, c)
        for sweep, few, scale in (("gate", (1.0, -0.75, 0.3, 2.5), 1.0),
                                  ("value", (0.0, 1.5, -2.0, 8.0), 3.0)):
            rows = []
            for f in few:
                const = torch.full_like(grid, f)
                rows.append(torch.cat((const, grid) if sweep == "gate" else (grid, const), 1))
            h = torch.cat(rows).contiguous()
            d = (glu_requant(h, scale).int() - glu_requant_plain(h, scale).int()).abs()
            n_diff, dmax = int((d > 0).sum()), d.max().item()
            check(dmax <= 1 and n_diff <= 1e-3 * d.numel(),
                  f"{name} == plain over every finite bf16 {sweep} x {len(few)}: {n_diff} of "
                  f"{d.numel()} differ, max {dmax} step")
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
        ms = cuda_ms_median(lambda: glu_requant(x, scale))
        d_ms = device_ms(torch, lambda: glu_requant(x, scale), iters=20)
        p_ms = cuda_ms_median(lambda: glu_requant_plain(x, scale), iters=5)
        f_ms = copy_floor_ms(torch, x, torch.int64)
        nbytes = x.numel() * 2 + x.numel() // 2  # bf16 in, int8 out
        ops = 10 * (x.numel() // 2)  # sigmoid, product, divide, clip, round per output
        bms, by = bound_ms(nbytes, ops)
        print(f"  {name} {site} x{n}: kernel {ms:.4f} ms (device time {d_ms:.4f}), plain "
              f"{p_ms:.4f} ms, copy floor {f_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
              f"{bms / ms:.1%} of it reached, {bms / d_ms:.1%} by device time)", flush=True)
        rows[name].append(dict(ms=n * ms, device_ms=n * d_ms, plain_ms=n * p_ms,
                               copy_floor_ms=n * f_ms, bound_ms=n * bms, nbytes=n * nbytes,
                               flops=n * ops, err=float(dmax)))
    out = []
    for (line, c), name in zip(((72, 64), (96, 32)), ("glu_requant_one", "glu_requant_pair")):
        tot = sums(rows[name], keys=("ms", "device_ms", "plain_ms", "copy_floor_ms", "bound_ms",
                                     "nbytes", "flops"))
        tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"))[1]
        out.append({"name": name, "route": "cuda", "source": "tgsr_tpu_torch/csrc/glu_requant.cu",
                    "replaces": f"examples/glu_pallas_probe.py:{line}", **tot,
                    "library_ms": None,
                    "shapes": f"B {B}, c {c}, the sites of one int8 forward; max_abs_err in "
                              "int8 steps; ms, plain_ms, copy_floor_ms by CUDA events (median "
                              "of five 20-call means), device_ms with the host's launches "
                              "queued behind a spin kernel; copy_floor_ms the same bytes "
                              "through one PyTorch int64 -> int16 cast"})
    return out


def requant_phase(torch):
    """`requant` (X2, the int8 path's input quantization) against
    `requant_plain` (`quantize_act`, the five torch ops the int8 path ran
    before) bit for bit: over every finite bfloat16 at three steps, then at
    the 26 requantized conv inputs of one B = 64 int8 forward, with inputs
    spread as activations and a calibrated-looking scale (the absmax less
    a tenth, so the tail clips). Times as `glu_requant_phase`."""
    from tgsr_tpu_torch.ops.glu_requant import requant, requant_plain

    every = finite_bf16(torch)
    for scale in REQUANT_SCALES:
        check(torch.equal(requant(every, scale), requant_plain(every, scale)),
              f"requant == quantize_act over every finite bf16, step {scale}/127")
    check(sum(n for *_, n in REQUANT_SITES) == 26,
          f"26 requantized conv inputs a forward ({sum(n for *_, n in REQUANT_SITES)})")
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for site, h, w, cin, n in REQUANT_SITES:
        x = (torch.randn(B, h, w, cin, generator=g, device="cuda")
             * torch.rand(cin, generator=g, device="cuda") * 4).bfloat16()
        scale = 0.9 * x.float().abs().max().item()
        got, ref = requant(x, scale), requant_plain(x, scale)
        torch.cuda.synchronize()
        err = (got.int() - ref.int()).abs().max().item()
        check(torch.equal(got, ref), f"requant == quantize_act at {site} [{B},{h},{w},{cin}] "
                                     f"(max {err} step)")
        ms = cuda_ms_median(lambda: requant(x, scale))
        d_ms = device_ms(torch, lambda: requant(x, scale), iters=20)
        p_ms = cuda_ms_median(lambda: requant_plain(x, scale), iters=5)
        f_ms = copy_floor_ms(torch, x, torch.int32)
        nbytes = 3 * x.numel()  # bf16 in, int8 out
        ops = 4 * x.numel()  # divide, clip, round
        bms, by = bound_ms(nbytes, ops)
        print(f"  requant {site} x{n}: kernel {ms:.4f} ms (device time {d_ms:.4f}), plain "
              f"{p_ms:.4f} ms, copy floor {f_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
              f"{bms / ms:.1%} of it reached, {bms / d_ms:.1%} by device time)", flush=True)
        rows.append(dict(ms=n * ms, device_ms=n * d_ms, plain_ms=n * p_ms, copy_floor_ms=n * f_ms,
                         bound_ms=n * bms, nbytes=n * nbytes, flops=n * ops, err=float(err)))
    tot = sums(rows, keys=("ms", "device_ms", "plain_ms", "copy_floor_ms", "bound_ms", "nbytes",
                           "flops"))
    tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"))[1]
    return {"name": "requant", "route": "cuda", "source": "tgsr_tpu_torch/csrc/glu_requant.cu",
            "replaces": "tgsr_tpu/engine/quant.py:137 (quantize_act; XLA, no Pallas kernel)",
            **tot, "library_ms": None,
            "shapes": f"B {B}, the 26 requantized conv inputs of one int8 forward (18 shapes); "
                      "plain_ms the five torch ops of quantize_act; max_abs_err in int8 steps; "
                      "ms, plain_ms, copy_floor_ms by CUDA events (median of five 20-call "
                      "means), device_ms with the host's launches queued behind a spin "
                      "kernel; copy_floor_ms the same bytes through one PyTorch int32 -> "
                      "int16 cast"}


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers and spill bytes of `kernel` in a `ptxas -v` log."""
    lines = log.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if "Compiling entry function" in line and kernel in line)
    out = {}
    for line in lines[start + 1:start + 6]:
        if "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out["stack_bytes"], out["spill_store_bytes"], out["spill_load_bytes"] = nums[:3]
        elif "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out


def conv_probe_phase(torch):
    """The conv probe path at full size (B = 64, 128 x 128 px, h_net3's
    ResBlock conv1): first each kernel against its plain version on the
    probe's own inputs, within one bfloat16 ulp (`conv_probe.max_ulps`:
    float32 sums in another order, each output rounded once); then the path
    itself, `probes.conv_probe.main`, with the launch counts set to 0 just
    before and read just after. Beside the path's CUDA-event times, each
    kernel's and cuDNN's `device_ms` (the calls queued behind a spin
    kernel), and the `ptxas -v` registers and spills of the four kernels,
    none of which may spill. Returns the four kernel rows and those counts."""
    from tgsr_tpu_torch.ops import _build
    from tgsr_tpu_torch.ops import conv_probe as cp
    from tgsr_tpu_torch.probes import conv_probe as path

    h = w = 128
    x, wt, wp, p = path.make_inputs("cuda", B, h, w)
    args = {"tap9": (x, wt), "im2col": (x, wp), "pair5": (x, wp), "dotceil": (p, wp)}
    errs = {}
    for name, _ in CONV_PROBE:
        got = getattr(cp, name)(*args[name])
        ref = getattr(cp, f"{name}_plain")(*args[name])
        torch.cuda.synchronize()
        ulps = cp.max_ulps(got, ref)
        errs[name] = (got.float() - ref.float()).abs().max().item()
        check(ulps <= 1, f"conv probe {name} == plain at {tuple(args[name][0].shape)} "
                         f"(max abs err {errs[name]:.3e}, {ulps:.2f} bf16 ulp <= 1)")
        del got, ref
    torch.cuda.empty_cache()

    _build.reset_launches()
    res = path.main(device="cuda", b=B, h=h, w=w)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    probe_names = {f"conv_{name}" for name, _ in CONV_PROBE}
    check(all(counts[n] > 0 for n in probe_names)
          and not any(v for n, v in counts.items() if n not in probe_names),
          f"the conv probe path launched its four kernels and nothing else ({counts})")

    log = _build.build_log("conv_probe")
    usage = {name: ptxas_usage(log, f"conv_{name}_kernel") for name, _ in CONV_PROBE}
    for name, u in usage.items():
        check(u["spill_store_bytes"] == 0 and u["spill_load_bytes"] == 0,
              f"conv probe {name} ptxas: {u['registers']} registers, {u['spill_store_bytes']} "
              f"bytes spill stores, {u['spill_load_bytes']} bytes spill loads (no spills)")
    lib_dms = device_ms(torch, lambda: cp.conv_library(x, wt), iters=10)
    mm_dms = device_ms(torch, lambda: torch.matmul(p, wp), iters=10)
    n_px, rows = B * h * w, []
    for name, line in CONV_PROBE:
        row = res["rows"][name]
        d_ms = device_ms(torch, lambda: getattr(cp, name)(*args[name]), iters=10)
        if name == "dotceil":
            m = p.numel() // cp.KP
            nbytes, flops = 2 * (p.numel() + wp.numel() + m * cp.COUT), 2 * m * cp.KP * cp.COUT
        else:
            weight = wt if name == "tap9" else wp
            nbytes = 2 * (n_px * (cp.CIN + cp.COUT) + weight.numel())
            flops = path.conv_flops(B, h, w)  # the conv's work; im2col and pair5 compute 640/576 of it
        bms, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        l_dms = mm_dms if name == "dotceil" else lib_dms
        print(f"  conv probe {name}: kernel {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s; device "
              f"time {d_ms:.4f}), plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
              f"(device time {l_dms:.4f}), bound {bms:.4f} ms ({by}, {bms / row['ms']:.1%} of it "
              f"reached, {bms / d_ms:.1%} by device time)", flush=True)
        rows.append({"name": f"conv_{name}", "route": "cuda",
                     "source": "tgsr_tpu_torch/csrc/conv_probe.cu",
                     "replaces": f"examples/pallas_conv_probe.py:{line}",
                     "max_abs_err": errs[name], "ms": row["ms"], "device_ms": d_ms,
                     "plain_ms": row["plain_ms"], "bound_ms": bms, "bound_by": by,
                     "library_ms": row["library_ms"], "library_device_ms": l_dms,
                     "tflops": row["tflops"], **usage[name],
                     "shapes": (f"p {tuple(p.shape)} @ wp (640, 128); library torch.matmul"
                                if name == "dotceil" else
                                f"x [{B},{h},{w},64] -> 128 channels, 3x3 SAME; library "
                                "cuDNN bf16 conv (conv_library)")
                               + "; ms by CUDA events, device_ms with the host's launches "
                                 "queued behind a spin kernel"})
    d = res["decision"]
    print(f"  conv probe decision: {d['best']} {d['best_ms']:.4f} ms = {d['ratio']:.2f}x cuDNN's "
          f"{d['library_ms']:.4f} ms -> {d['verdict']}", flush=True)
    return rows, counts


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
                                     "glu_requant_pair": 10, "requant": 26}}[tag])
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
               requant_phase(torch), int8_conv_phase(torch)]
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = pipeline_phase(torch, rng, card)
    print(f"pipeline phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    probe_rows, launches["conv_probe"] = conv_probe_phase(torch)
    kernels += probe_rows
    print(f"conv probe phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # launches: the runs of each path, the serving forward in f32, bf16 and
    # int8 and the conv probe (counted apart per path; "launches" is their sum)
    for k in kernels:
        k["launches"] = sum(run[k["name"]] for run in launches.values())
        k["launches_by_path"] = {tag: run[k["name"]] for tag, run in launches.items()}
        for tag in ("float32", "bfloat16"):
            if tag in k:
                k[tag]["launches"] = launches[tag][k["name"]]
        paths = [tag for tag, n in k["launches_by_path"].items() if n]
        check(k["launches"] > 0, f"{k['name']} launched on its path ({', '.join(paths)})")
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
