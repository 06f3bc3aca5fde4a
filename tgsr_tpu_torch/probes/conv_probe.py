"""Go/no-go probe for a whole-stage fused kernel, on the card.

    python -m tgsr_tpu_torch.probes.conv_probe

The counterpart of examples/pallas_conv_probe.py. A whole-stage kernel
(ResBlock x2 + attention + upsample per tile) spends most of its time in
conv3x3 products, so it can only win if a hand-written conv matches the
library's at the model's hottest conv: h_net3's ResBlock conv1, [B, 128,
128, 64] -> 128 channels, bf16, float32 sums. The probe times the library
conv (cuDNN, `conv_library`) and the three hand-written formulations of
`tgsr_tpu_torch/ops/conv_probe.py` (`tap9`, `im2col`, `pair5`), plus
`dotceil`, a plain K = 640 product on a precomputed patch tensor, beside
`torch.matmul` on the same inputs. All four are hand-written `wgmma`
kernels fed by TMA (`tgsr_tpu_torch/csrc/conv_probe.cu`).

Decision: if the best of (tap9, im2col, pair5) takes at most GO_RATIO times
the library conv's time, the fusion's savings in device memory traffic ride
on top and the stage kernel is worth building ("go"); otherwise a fused
stage cannot pay for its conv content ("no-go").

Each kernel is first held against its plain version on the same inputs
(within one bf16 ulp, `max_ulps`); a kernel that fails to build, launch or
match makes the run fail. Device times come from CUDA events over warm
repetitions. On the CPU (`main(device="cpu", ...)`) the wrappers run their
plain versions and nothing is timed.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from tgsr_tpu_torch.ops import conv_probe as cp

GO_RATIO = 1.1
REPS = 20  # timed calls of each kernel and library call
DOT_TILE = 16  # rows of the TPU probe's dotceil tile: p is [B * H / 16, 16 * W, 640]


def conv_flops(b: int, h: int, w: int) -> int:
    return 2 * b * h * w * 9 * cp.CIN * cp.COUT


def make_inputs(device, b: int, h: int, w: int):
    """x [b, h, w, 64], w [3, 3, 64, 128], wp = pack_w(w) and the patch
    tensor p [b * h / 16, 16 * w, 640], bf16, from a seeded generator."""
    if h % DOT_TILE:
        raise ValueError(f"conv probe: h {h} must be a multiple of {DOT_TILE}")
    g = torch.Generator(device=device).manual_seed(0)

    def normal(*shape, sd):
        return (torch.randn(shape, generator=g, device=device) * sd).to(torch.bfloat16)

    x = normal(b, h, w, cp.CIN, sd=0.1)
    wt = normal(3, 3, cp.CIN, cp.COUT, sd=0.05)
    p = normal(b * h // DOT_TILE, DOT_TILE * w, cp.KP, sd=0.1)
    return x, wt, cp.pack_w(wt), p


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
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


def main(device: str = "cuda", b: int = 64, h: int = 128, w: int = 128) -> Dict:
    """Runs the probe; returns {"device", "shape", "gflop", "rows",
    "decision"}. rows[name] holds the max abs error and ulps against the
    plain version (kernel rows), and on the card ms, plain_ms, library_ms
    and TFLOP/s (conv rows on the conv's FLOP, dotceil on its own)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("conv probe: no CUDA card; pass device='cpu' for the plain versions")
    x, wt, wp, p = make_inputs(device, b, h, w)
    flops = conv_flops(b, h, w)
    dot_flops = 2 * p.numel() // cp.KP * cp.KP * cp.COUT
    calls = {
        "tap9": (cp.tap9, cp.tap9_plain, (x, wt)),
        "im2col": (cp.im2col, cp.im2col_plain, (x, wp)),
        "pair5": (cp.pair5, cp.pair5_plain, (x, wp)),
        "dotceil": (cp.dotceil, cp.dotceil_plain, (p, wp)),
    }
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device {kind}, conv3x3 [{b},{h},{w},{cp.CIN}]->[{b},{h},{w},{cp.COUT}] bf16, "
          f"{flops / 1e9:.1f} GFLOP; dotceil {tuple(p.shape)} @ {tuple(wp.shape)}, "
          f"{dot_flops / 1e9:.1f} GFLOP", flush=True)

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' float32 products
    try:
        rows = {}
        ref = cp.tap9_plain(x, wt)
        lib_ulps = cp.max_ulps(cp.conv_library(x, wt), ref)
        rows["conv_library"] = {"max_ulps_vs_tap9_plain": lib_ulps}
        print(f"conv_library vs tap9_plain: {lib_ulps:.2f} bf16 ulp", flush=True)
        if not lib_ulps <= 4:
            raise AssertionError(f"conv probe: the library conv is {lib_ulps:.2f} ulp from "
                                 "tap9_plain (> 4): not the same function")
        for name, (kernel, plain, args) in calls.items():
            got, want = kernel(*args), plain(*args)
            ulps = cp.max_ulps(got, want)
            err = (got.float() - want.float()).abs().max().item()
            print(f"{name} vs its plain version: max abs err {err:.3e}, {ulps:.2f} bf16 ulp",
                  flush=True)
            if not ulps <= 1:
                raise AssertionError(f"conv probe: {name} differs from its plain version by "
                                     f"{ulps:.2f} bf16 ulp (> 1)")
            rows[name] = {"max_abs_err": err, "max_ulps": ulps}
        del ref, got, want
        if not on_card:
            print("times: not measured (no card)", flush=True)
            return {"device": kind, "shape": [b, h, w], "gflop": flops / 1e9, "rows": rows,
                    "decision": None}

        lib_ms = cuda_ms(lambda: cp.conv_library(x, wt), REPS)
        mm_ms = cuda_ms(lambda: torch.matmul(p, wp), REPS)
        rows["conv_library"].update(ms=lib_ms, tflops=flops / lib_ms / 1e9)
        print(f"{'conv_library (cuDNN)':26s} {lib_ms:8.4f} ms {flops / lib_ms / 1e9:7.1f} TFLOP/s",
              flush=True)
        for name, (kernel, plain, args) in calls.items():
            ms = cuda_ms(lambda: kernel(*args), REPS)
            plain_ms = cuda_ms(lambda: plain(*args), 3, warmup=1)
            f = dot_flops if name == "dotceil" else flops
            library = mm_ms if name == "dotceil" else lib_ms
            rows[name].update(ms=ms, plain_ms=plain_ms, library_ms=library,
                              tflops=f / ms / 1e9)
            print(f"{name:26s} {ms:8.4f} ms {f / ms / 1e9:7.1f} TFLOP/s; plain {plain_ms:.4f} "
                  f"ms, library {library:.4f} ms ({'torch.matmul' if name == 'dotceil' else 'cuDNN'})",
                  flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    best = min(("tap9", "im2col", "pair5"), key=lambda n: rows[n]["ms"])
    ratio = rows[best]["ms"] / lib_ms
    verdict = "go" if ratio <= GO_RATIO else "no-go"
    decision = {"best": best, "best_ms": rows[best]["ms"], "library_ms": lib_ms,
                "ratio": ratio, "verdict": verdict}
    print(f"decision: best hand conv {best} {rows[best]['ms']:.4f} ms = {ratio:.2f}x the library "
          f"conv's {lib_ms:.4f} ms -> {verdict} (go at <= {GO_RATIO}x)", flush=True)
    return {"device": kind, "shape": [b, h, w], "gflop": flops / 1e9, "rows": rows,
            "decision": decision}


if __name__ == "__main__":
    print(json.dumps(main()))
