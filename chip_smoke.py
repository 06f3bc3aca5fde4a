"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tgsr_tpu_torch/csrc/ with nvcc (sm_90a),
holds each kernel against its plain PyTorch version at the shapes of the x8
face-SR serving path, then drives that path (SRPipeline at the face S8
geometry, full width, seeded weights, float32) and checks that it went
through the kernels and agrees with the same pipeline on the CPU, where
every kernel site runs its plain version. Prints one JSON line
of per-kernel numbers, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without that line when there
is no CUDA card, when the package is missing, or when any check fails.
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
B = 64  # batch of the kernel phases
T, C = 18, 32  # caption slots and attention width of the face S8 path
FAILURES: list = []


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


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_phase(torch, rng):
    import torch.nn.functional as F

    from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain
    from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention

    lens = rng.integers(1, T + 1, B)
    lens[1] = 0  # one caption with every token padded
    mask = torch.as_tensor(np.arange(T)[None, :] >= lens[:, None], device="cuda")
    words = torch.randn(B, T, C, device="cuda")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0, nbytes=0, flops=0)
    for hw in (32, 64, 128):
        px = torch.randn(B, hw, hw, C, device="cuda")
        ctx_p, attn_p = plain(px, words, mask)
        ctx_k, attn_k = word_pixel_attention(px, words, mask)
        torch.cuda.synchronize()
        err = max((ctx_k - ctx_p).abs().max().item(), (attn_k - attn_p).abs().max().item())
        check(err <= 1e-4, f"attention kernel == plain at [{B},{hw},{hw},{C}] T {T} "
                           f"(max abs err {err:.3e} <= 1e-4)")
        q, kv = px.reshape(B, hw * hw, C), words
        keep = ~mask[:, None, :]
        ms = cuda_ms(lambda: word_pixel_attention(px, words, mask, return_attn=False))
        p_ms = cuda_ms(lambda: plain(px, words, mask, return_attn=False))
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep, scale=1.0))
        n = B * hw * hw
        nbytes = 4 * (2 * n * C + B * T * C) + B * T  # pixels in, ctx out, words, mask
        flops = n * (4 * T * C + 5 * T)  # two T x C products + softmax
        bms, by = bound_ms(nbytes, flops)
        print(f"  attention {hw}x{hw}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"sdpa {l_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        for key, val in (("ms", ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                         ("bound_ms", bms), ("nbytes", nbytes), ("flops", flops)):
            tot[key] += val
        tot["err"] = max(tot["err"], err)
    return {"name": "word_pixel_attention", "route": "cuda",
            "source": "tgsr_tpu_torch/csrc/word_pixel_attention.cu",
            "replaces": "tgsr_tpu/ops/pallas_attention.py:30",
            "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": bound_ms(tot["nbytes"], tot["flops"])[1],
            "library_ms": tot["library_ms"],
            "shapes": f"B {B}, C {C}, T {T}, HW 32^2+64^2+128^2 (one forward's three sites)"}


def up_head_phase(torch):
    from tgsr_tpu_torch.ops.up_head import fold_bn, fused_up_head, reference_up_head

    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, nbytes=0, flops=0)
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
        for key, val in (("ms", ms), ("plain_ms", p_ms), ("bound_ms", bms),
                         ("nbytes", nbytes), ("flops", flops)):
            tot[key] += val
        tot["err"] = max(tot["err"], err)
    return {"name": "up_head", "route": "cuda",
            "source": "tgsr_tpu_torch/csrc/up_head.cu",
            "replaces": "tgsr_tpu/ops/pallas_up_head.py:78",
            "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": bound_ms(tot["nbytes"], tot["flops"])[1],
            "library_ms": None,
            "shapes": f"B {B}, 128->256 px, both sites of one forward"}


def pipeline_phase(torch, rng, card):
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.ops import _build

    cfg = face_s8_config()
    vocab = 41
    sds = init_seeded(cfg, vocab, torch.Generator().manual_seed(0))
    kern = SRPipeline(cfg, vocab, *sds, device="cuda")
    # the reference: the same weights on the CPU, where every kernel site
    # runs its plain version
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
    _build.reset_launches()
    got = kern(lr8f, cap8, lens8)["sr"]
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    check(counts == {"word_pixel_attention": 3, "up_head": 2},
          f"one forward launches 3 attention and 2 up-head kernels ({counts})")
    check(tuple(got.shape) == (8, 256, 256, 3) and bool(torch.isfinite(got).all()),
          f"SR is finite, shape {tuple(got.shape)}")
    err = (got.cpu() - ref).abs().max().item()
    check(err <= 1e-3, f"SR of the card's kernels == plain on the CPU, f32 "
                       f"(max abs err {err:.3e} <= 1e-3)")
    du8 = (to_uint8(got).cpu().int() - to_uint8(ref).int()).abs().max().item()
    check(du8 <= 1, f"uint8 SR kernels vs plain differ by at most 1 (max {du8})")
    one = kern(lr8f[:1], cap8[:1], lens8[:1])["sr"]
    err1 = (one[0] - got[0]).abs().max().item()
    check(err1 <= 1e-4, f"row 0 of the mixed-length batch == its B=1 result "
                        f"(max abs err {err1:.3e} <= 1e-4)")
    check(float(got.std()) > 1e-3, f"SR is not constant (std {float(got.std()):.4f})")

    n, mb = 100, 64
    lr, cap, lens = batch(n)
    kern.sr_batched(lr, cap, lens, microbatch=mb)  # warm-up at the same shapes
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = kern.sr_batched(lr, cap, lens, microbatch=mb)
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    m = -(-n // mb)
    check(launches == {"word_pixel_attention": 3 * m, "up_head": 2 * m},
          f"sr_batched N={n} microbatch {mb}: {m} forwards went through the kernels ({launches})")
    check(out.shape == (n, 256, 256, 3) and out.dtype.name == "uint8" and out.std() > 1,
          f"sr_batched output uint8 {out.shape}")
    print(f"  sr_batched N={n} microbatch {mb}: {dt:.4f} s, {n / dt:.2f} img/s "
          f"(f32, seeded weights) on {card}", flush=True)
    profile_forward(torch, kern, lr[None, :mb], cap[None, :mb], lens[None, :mb])
    return launches


def profile_forward(torch, pipe, lr, cap, lens, top: int = 12) -> None:
    """Device time of one B=64 forward by kernel (torch.profiler, CUPTI)."""
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
    print(f"  profile of one forward at B={lr.shape[1]}: device {dev:.3f} ms, "
          f"wall {wall:.3f} ms under the profiler, idle share "
          f"{max(0.0, 1 - dev / wall):.3f}", flush=True)
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
    kernels = [attention_phase(torch, rng), up_head_phase(torch)]
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = pipeline_phase(torch, rng, card)
    print(f"pipeline phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
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
