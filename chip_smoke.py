"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --step-readings SEEDS [--damsm] [--out readings.json]

The second form only runs `step_against_cpu` on the batches of SEEDS (such
as 1-12 or 5,5,6) and prints, for each card step, the median and 90th
percentile of its gradient ratios on each batch and each tensor's largest
ratio over the batches (what GRAD_MEDIAN and GRAD_OUTLIER_FACTOR are set
from; with --damsm, G's step with the DAMSM terms of a SimpleCNN trained
one epoch as damsm_phase trains it, and that encoder's backward alone).

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
against the float32 reference. On the card sr_batched replays the forward
captured as a CUDA graph, so those launch counts are the captured counts
times the replays; each path is profiled eager and under replay. What
TF32 does to the float32 path is printed (tf32_effect). Then the
serving phase, per path: replay bit for bit against the eager __call__,
sr_arbitrary at ragged LR shapes against the plain pipelines on the CPU,
B = 1 latency and img/s eager against replay, the memory plan (bfloat16:
N = plan + 1 under its budget), an int8 bundle and a .pth checkpoint round
trip, and BatchingServer (bfloat16, 8 threads, 256 requests). Then the
front door: three threads on one bfloat16 pipeline (each result bit for bit
its solo call, one capture while the others run); the export entry points
(aot_phase: each path's exported program, symbolic batch, loaded as an
AOTPipeline, bit for bit the live pipeline at B = 1, 3 and 64 with the live
path's launches, the float32 one loaded with TF32 switched on; x16 bf16 at
B = 8; cli.export_aot tracing on the CPU, its program run on the card; a
loader process that imports no model module; cli.serve --aot); the HTTP server of
tgsr_tpu_torch.cli.serve booted from a YAML config, .pth files and a vocab
pickle (bfloat16, the shipped NET_E) and from an int8 bundle, answering
concurrent fixed-size and native POSTs against the direct pipeline; and
evaluate_sr on 64 images in float32 and bfloat16 against float32 on the
CPU. Then the eval and calibration entry points (tgsr_tpu_torch.cli.test
and .calibrate) on a face example set in the reference's layout, seeded .pth
files and the shipped NET_E: the bfloat16 default with the attention grids
and --metrics, --no-bf16 (attention maps against the CPU's), --int8 and
--no-bf16 --int8 (the float32 instances of the GLU-requant, requant and
int8 conv kernels, held against their plain versions in the kernel phases),
--arbitrary, a deployment bundle, a calibration against the CPU's, --scales
and the fidelity gate's refusal. Then the x16 family (configs/eval_faceSR_S16
.yml, BRANCH_NUM 5, 32 px -> 512 px, full width, seeded weights): its
kernels first held against their plain versions at its shapes (256 px
attention, both 512 px up-head sites, tanh without a blend included, its
int8 conv, GLU-requant and requant sites in their bfloat16 and float32
instances), then float32, bfloat16, int8 and
int8 with float32 compute against the same pipelines on the CPU, each
forward's launches, the replay against eager, the memory plan (bfloat16: N
= plan and plan + 1 under its budget), a profile of each path, and the HTTP
server booted from that YAML answering 512 px POSTs. Then drives the conv
probe path (tgsr_tpu_torch.probes.conv_probe at B = 64, 128 x 128 px), whose
four tensor-core kernels (tap9, im2col, pair5 and dotceil, all on wgmma with
TMA-fed operands) are first held against their plain versions within one
bfloat16 ulp, and none of which may spill registers. Training (the x8
face S8 model at full width): the attention's backward kernel against
autograd of its plain version at the three training sites, one step on the
card against the same step on the CPU (both held against a float64 step),
ten steps at B = 16 in float32 and bfloat16 with their launches, times and
memory, and the training CLI, whose last snapshot pair SRPipeline serves
equal to the run's EMA generator. x16 training (x16_train_phase;
configs/train_faceSR_S16.yml at full width, 32 px -> 512 px): the
attention forward and backward kernels at its four training sites (B = 16,
up to 256 px) against their plain versions, GANTrainer.plan_batch() in
float32 and bfloat16 with remat False and 'all' (a fresh run at each plan
under its budget; the face S8 training's CPU steps made beside them), five
steps of each at B = 16 with their launches, times, memory and a profile,
the remat step against the plain one bit for bit under deterministic
algorithms, one step against a float64 CPU step (remat
False and 'all'), and the CLI with --remat all, whose snapshot the x16
SRPipeline serves equal to the run's EMA generator. DAMSM (damsm_phase; the DAMSM face
configuration at full width: 299 px, T 18, nef 256): ten DAMSMTrainer steps
with the seeded Inception-v3 encoder at B = 48 in float32 and bfloat16 (one
step at B = 8 against the CPU's), the pretraining CLI for both encoder
families with a resume, the GAN trainer with the DAMSM terms (ten steps at
B = 16, the card's step against a float64 CPU step, the Inception terms
giving G no gradient) and its CLI's --image_encoder, and the R-precision
CLI on 64 images against the CPU's similarities. The EVAL switches
(eval_variants_phase): the face S8 pipeline with INPUT_NETGH 'lr-lrblur' and
weight maps (float32, bfloat16, int8), 'lrblur' (float32) and STAGE1 (all
three) at B = 64 against the CPU, with their launches, the replay and a
profile; x16 bfloat16 with the blur and maps; rows 2 and 3 blending a
per-pixel map against their plain versions, timed beside the scalar; the
weight-map program exported and loaded; GAN steps with the blur and maps (the
card's step against a float64 CPU step, B = 16 steps, an x16 step, a
snapshot served back); the HF branch's library modules on the card. The
GRU text encoder (gru_phase: RNN_TYPE 'GRU' in float32, bfloat16 and int8
against the CPU with the LSTM path's launches, replay, an exported program,
the text encoders timed, a GAN and a DAMSM step against the CPU) and the
library the JAX package exports (library_phase: the blocks, weighted
attention, variants, ESRGANDNet, VGG16, orthogonal_reinit and the loss
families, each on the card against the CPU). Training that resumes and
spreads over ranks (train_scale_phase: world size 1 over NCCL, face S8 at
full width, B = 16; the data-parallel and --fsdp steps bit for bit the
plain step under deterministic algorithms with rows 1 and 1 bwd launched 3
times a step, the train-state checkpoint's bytes, save, write and restore
times and the step's time while a write is in flight, and cli.train_gan
--mesh 1x1 stopped by SIGTERM and resumed, ending on the whole run's
snapshot bytes; `--step-readings` also prints how many of its batches
exceed the cuDNN-off median gate, ROADMAP C 6). The input side
(data_phase, after the eval CLIs): the committed JPEG and PNG fixtures
decoded bit for bit as PIL on the card's host, the host loader's img/s,
cli.test on flower and coco JPEG example sets (configs/eval_flowerSR_attn2.yml,
eval_cocoSR_attn2.yml at full width) in bfloat16 and float32 against the
CPU, a JPEG POSTed to cli.serve in both modes, profile_trace naming the
kernels of a forward, and nan_guard over one training step. Prints
one JSON line of per-kernel numbers, then, as the last line, {"ok": true,
"device": {...}}.
Exits non-zero without that line when there is no CUDA card, when the
package is missing, or when any check fails.
"""

from __future__ import annotations

import gc
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import tempfile
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
# the same floor for the x16 family (x16_phase's weights and images): the
# CPU's int8-versus-float32 PSNR at full width, which x16_phase prints, less
# 1 dB (44.33 dB in tests/test_torch_pipeline_x16.py's rehearsal of the phase
# on the CPU; PERF.md)
X16_INT8_PSNR_FLOOR = 43.3
HERE = os.path.dirname(os.path.abspath(__file__))
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
# the most uint8 levels an int8 (bfloat16 compute) request served in a batch
# of up to 8 came out from itself served alone (B = 1) on one H100:
# tgsr_tpu_torch/probes/batch_variance.py, face S8, six weight seeds x 64
# requests, each reading twice; its only origin is the text encoder's
# cuBLAS GEMMs, which change kernel with the batch (float32 and bfloat16: 1)
INT8_BATCH_LEVELS = 2
# the two up-head sites of one forward: (Cin, C2, k, tanh, blend, site)
UP_HEAD_SITES = ((64, 64, 3, False, False, "h_net3.upsample+img_net3"),
                 (32, 64, 5, True, True, "upscale8x+conv_output+a*srb"))

# the x16 family (configs/eval_faceSR_S16.yml, BRANCH_NUM 5, 32 px -> 512 px):
# h_net2 == h_net3 == h_net4 and img_net1 == .. == img_net4 are one module
# each, run three and four times; NetGHighWeight16's 512 px step runs
# residual48 and upscale8x again. Its attention sites (px), up-head sites at
# 256 -> 512 px (the shared stage's last call: 3x3 head, tanh, NO blend;
# upscale8x's second call: the 5x5 head, tanh, + a * nearest2x(srb[2])),
# and its int8 sites as the x8 tables above
X16_ATTENTION = (32, 64, 128, 256)
UP_HEAD_SITES_X16 = ((64, 64, 3, True, False, "h_net2.upsample+img_net1 (tanh, no blend)"),
                     (32, 64, 5, True, True, "upscale8x+conv_output+a*nearest2x(srb[2])"))
INT8_CONVS_X16 = (
    ("h_net1/im2f_conv", 32, 32, 3, 64, 3, False, False, False, 1),
    ("h_net1/residual_*/conv1", 32, 32, 64, 128, 3, False, True, False, 2),
    ("h_net1/residual_*/conv2", 32, 32, 64, 64, 3, False, True, True, 2),
    ("h_net1/upsample/conv", 32, 32, 64, 64, 3, True, True, False, 1),
    *(entry for px in (64, 128, 256) for entry in (
        (f"img_net1/conv {px}", px, px, 32, 3, 3, False, False, False, 1),
        (f"h_net2/residual_*/conv1 {px}", px, px, 64, 128, 3, False, True, False, 2),
        (f"h_net2/residual_*/conv2 {px}", px, px, 64, 64, 3, False, True, True, 2),
        (f"h_net2/upsample/conv {px}", px, px, 64, 64, 3, True, True, False, 1))),
    ("img_net1/conv 512", 512, 512, 32, 3, 3, False, False, False, 1),
    ("convin/conv", 32, 32, 3, 64, 3, False, False, False, 1),
    ("residual_*/conv1", 32, 32, 32, 64, 3, False, True, False, 6),
    ("residual_*/conv2", 32, 32, 32, 32, 3, False, True, True, 6),
    ("upscale2x/conv", 32, 32, 32, 64, 3, True, True, False, 1),
    ("conv_output/conv 64", 64, 64, 32, 3, 5, False, False, False, 1),
    ("residual24/conv1", 64, 64, 32, 64, 3, False, True, False, 1),
    ("residual24/conv2", 64, 64, 32, 32, 3, False, True, False, 1),
    ("upscale4x/conv", 64, 64, 32, 64, 3, True, True, False, 1),
    *(entry for px in (128, 256) for entry in (
        (f"conv_output/conv {px}", px, px, 32, 3, 5, False, False, False, 1),
        (f"residual48/conv1 {px}", px, px, 32, 64, 3, False, True, False, 1),
        (f"residual48/conv2 {px}", px, px, 32, 32, 3, False, True, False, 1),
        (f"upscale8x/conv {px}", px, px, 32, 64, 3, True, True, False, 1))),
    ("conv_output/conv 512", 512, 512, 32, 3, 5, False, False, False, 1),
)
# in x16 no UpBlock's GLU output feeds only an int8 head, so every conv but
# the ResBlock and residual-sequence conv2s requantizes its input
REQUANT_SITES_X16 = tuple((site, h, w, cin, n) for site, h, w, cin, _, _, _, _, _, n
                          in INT8_CONVS_X16 if "conv2" not in site)
GLU_SITES_X16 = (
    ("h_net1/residual_*", 32, 32, 64, 2),
    *((f"h_net2/residual_* {px}", px, px, 64, 2) for px in (64, 128, 256)),
    ("netgh residual_*", 32, 32, 32, 6), ("residual24", 64, 64, 32, 1),
    ("residual48 128", 128, 128, 32, 1), ("residual48 256", 256, 256, 32, 1),
)
# one x16 forward's launches per path, attention at each of its four stages
X16_PER_FORWARD = {
    "float32": {"up_head": 2}, "bfloat16": {"up_head_packed": 2},
    "int8": {"int8_conv": 52, "glu_requant_one": 8, "glu_requant_pair": 9, "requant": 35},
    "int8 f32": {"int8_conv_f32": 52, "glu_requant_one_f32": 8, "glu_requant_pair_f32": 9,
                 "requant_f32": 35},
}

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


def attention_phase(torch, rng, hws=(32, 64, 128), b=B, what="forward"):
    """The attention kernel against its plain version at the sites of one
    forward (`hws`: x8's three, or the x16 family's four; `b` images, the
    serving phases' B = 64 or a training batch), in float32 and in
    bfloat16. The bfloat16 kernel is held
    against the plain version in float32 on the same bfloat16 inputs: it
    computes in float32 and rounds each output once, so |err| <= 2^-8 |ref|
    + 1e-5 elementwise."""
    import torch.nn.functional as F

    from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain
    from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention

    lens = rng.integers(1, T + 1, b)
    lens[1] = 0  # one caption with every token padded
    mask = torch.as_tensor(np.arange(T)[None, :] >= lens[:, None], device="cuda")
    words32 = torch.randn(b, T, C, device="cuda")
    out = {}
    for dtype, esize, rate in ((torch.float32, 4, F32_FLOP_PER_S),
                               (torch.bfloat16, 2, BF16_FLOP_PER_S)):
        tag = str(dtype).split(".")[-1]
        words = words32.to(dtype)
        rows = []
        for hw in hws:
            px = torch.randn(b, hw, hw, C, device="cuda").to(dtype)
            ctx_k, attn_k = word_pixel_attention(px, words, mask)
            if dtype == torch.float32:
                ctx_p, attn_p = plain(px, words, mask)
                torch.cuda.synchronize()
                err = max((ctx_k - ctx_p).abs().max().item(), (attn_k - attn_p).abs().max().item())
                check(err <= 1e-4, f"attention kernel == plain at [{b},{hw},{hw},{C}] T {T} "
                                   f"(max abs err {err:.3e} <= 1e-4)")
            else:
                ctx_p, attn_p = plain(px.float(), words.float(), mask)
                torch.cuda.synchronize()
                err = max((ctx_k.float() - ctx_p).abs().max().item(),
                          (attn_k.float() - attn_p).abs().max().item())
                excess = max(((ctx_k.float() - ctx_p).abs() - 2 ** -8 * ctx_p.abs()).max().item(),
                             ((attn_k.float() - attn_p).abs() - 2 ** -8 * attn_p.abs()).max().item())
                check(excess <= 1e-5, f"attention kernel bf16 == plain in f32 on the same "
                                      f"inputs at [{b},{hw},{hw},{C}] T {T} (max abs err "
                                      f"{err:.3e}, |err| - 2^-8 |ref| <= {excess:.2e} <= 1e-5)")
            q, kv = px.reshape(b, hw * hw, C), words
            keep = ~mask[:, None, :]
            # 50 calls: at the small sites each call takes the host longer than
            # the card, and one slow launch would move a mean of 10
            ms = cuda_ms(lambda: word_pixel_attention(px, words, mask, return_attn=False),
                         iters=50, warmup=5)
            d_ms = device_ms(torch, lambda: word_pixel_attention(px, words, mask,
                                                                 return_attn=False), iters=20)
            p_ms = cuda_ms(lambda: plain(px, words, mask, return_attn=False))
            l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep, scale=1.0))
            n = b * hw * hw
            nbytes = esize * (2 * n * C + b * T * C) + b * T  # pixels in, ctx out, words, mask
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
             "shapes": f"B {b}, C {C}, T {T}, HW {'+'.join(f'{hw}^2' for hw in hws)} (one "
                       f"{what}'s {len(hws)} sites); top level float32, 'bfloat16' the bf16 "
                       "instance; ms by CUDA events, device_ms with the host's launches "
                       "queued behind a spin kernel (the small sites take less than the "
                       "host's launch)"}
    return entry


def up_head_phase(torch, h=128, sites=UP_HEAD_SITES):
    """At both up-head sites of one forward (B = 64; x8: 128 -> 256 px, the
    x16 family: 256 -> 512 px, `sites` (Cin, C2, k, tanh, blend, name)): row 2
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
    w = h
    for cin, c2, k, use_tanh, blend, site in sites:
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
    shapes = f"B {B}, {h}->{2 * h} px, both sites of one forward"
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


def int8_conv_phase(torch, convs=INT8_CONVS):
    """`int8_conv` against its plain version (float64 convolution on the
    int8 values, exact) at every conv shape (`convs`) of one full-width
    B = 64 int8 forward: the int32 sums and the float32 epilogue bit for bit, the
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
    for site, h, w, cin, cout, k, up2, bn, res, n in convs:
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
            "shapes": f"B {B}, the {sum(c[-1] for c in convs)} convs of one int8 forward "
                      f"({len(convs)} shapes); ms, plain_ms and "
                      "cudnn_bf16_ms by CUDA events, device_ms and cudnn_bf16_device_ms by "
                      "CUDA events with the host's launches queued behind a spin kernel; "
                      "cudnn_bf16_* is cuDNN's bf16 conv on the same shapes, "
                      "for scale, not the same function"}


def glu_requant_phase(torch, sites=GLU_SITES, sweep=True):
    """Both `glu_requant` instances against their plain version, first (with
    `sweep`) over every finite bfloat16 gate (against four values) and every
    finite bfloat16 value (against four gates), then at one int8 forward's
    `sites` (B = 64): int8 equal except one step in at most 0.1 % of the elements (a
    gate or product on a bfloat16 rounding boundary). `ms`, `plain_ms` and
    `copy_floor_ms` (the same bytes through one PyTorch cast) by CUDA
    events, the median of five means (`cuda_ms_median`); `device_ms` with
    the host's launches queued behind a spin kernel (the small sites take
    less than the host's launch)."""
    from tgsr_tpu_torch.ops.glu_requant import INSTANCES, glu_requant, glu_requant_plain

    every = finite_bf16(torch)
    for c, name in sorted(INSTANCES.items()) if sweep else ():
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
    for site, h, w, c, n in sites:
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


def requant_phase(torch, sites=REQUANT_SITES, n_inputs=26, sweep=True):
    """`requant` (X2, the int8 path's input quantization) against
    `requant_plain` (`quantize_act`, the five torch ops the int8 path ran
    before) bit for bit: (with `sweep`) over every finite bfloat16 at three
    steps, then at the `n_inputs` requantized conv inputs (`sites`) of one
    B = 64 int8 forward, with inputs
    spread as activations and a calibrated-looking scale (the absmax less
    a tenth, so the tail clips). Times as `glu_requant_phase`."""
    from tgsr_tpu_torch.ops.glu_requant import requant, requant_plain

    every = finite_bf16(torch)
    for scale in REQUANT_SCALES if sweep else ():
        check(torch.equal(requant(every, scale), requant_plain(every, scale)),
              f"requant == quantize_act over every finite bf16, step {scale}/127")
    check(sum(n for *_, n in sites) == n_inputs,
          f"{n_inputs} requantized conv inputs a forward ({sum(n for *_, n in sites)})")
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for site, h, w, cin, n in sites:
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
            "shapes": f"B {B}, the {n_inputs} requantized conv inputs of one int8 forward "
                      f"({len(sites)} shapes); "
                      "plain_ms the five torch ops of quantize_act; max_abs_err in int8 steps; "
                      "ms, plain_ms, copy_floor_ms by CUDA events (median of five 20-call "
                      "means), device_ms with the host's launches queued behind a spin "
                      "kernel; copy_floor_ms the same bytes through one PyTorch int32 -> "
                      "int16 cast"}


def near_half(torch, p, step, rel=2.0 ** -20):
    """Where p / step lies within `rel` of it of a half-integer (float64)."""
    t = (p.double() / step).abs()
    return (t - t.floor() - 0.5).abs() <= rel * t


def glu_requant_f32_phase(torch, sites=GLU_SITES):
    """The float32 instances of rows 8 and 9 (`glu_requant` on float32 h,
    the int8 path with float32 compute) against their plain version at one
    int8 forward's `sites` (B = 64): int8 equal except one step where the
    product p / step lies within 2^-20 of a half-integer (a sigmoid's last
    bit), the count printed. Times as `glu_requant_phase`; the bound reads
    8 bytes and writes 1 per output."""
    from tgsr_tpu_torch.engine.quant import act_step
    from tgsr_tpu_torch.ops.glu_requant import INSTANCES, glu_requant, glu_requant_plain

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = {name + "_f32": [] for name in INSTANCES.values()}
    for site, h, w, c, n in sites:
        x = 1.5 * torch.randn(B, h, w, 2 * c, generator=g, device="cuda")
        scale = 2.0
        got, ref = glu_requant(x, scale), glu_requant_plain(x, scale)
        torch.cuda.synchronize()
        d = (got.int() - ref.int()).abs()
        p = x[..., :c] * torch.sigmoid(x[..., c:])
        n_diff = int((d > 0).sum())
        only_near = bool(near_half(torch, p, act_step(scale))[d > 0].all())
        del p
        name = INSTANCES[c] + "_f32"
        check(d.max().item() <= 1 and only_near,
              f"{name} == plain at {site} [{B},{h},{w},{2 * c}] f32: {n_diff} of {d.numel()} "
              f"differ by one step, each within 2^-20 of a half-step")
        ms = cuda_ms_median(lambda: glu_requant(x, scale))
        d_ms = device_ms(torch, lambda: glu_requant(x, scale), iters=20)
        p_ms = cuda_ms_median(lambda: glu_requant_plain(x, scale), iters=5)
        nbytes = x.numel() * 4 + x.numel() // 2  # f32 in, int8 out
        ops = 10 * (x.numel() // 2)
        bms, by = bound_ms(nbytes, ops)
        print(f"  {name} {site} x{n}: kernel {ms:.4f} ms (device time {d_ms:.4f}), plain "
              f"{p_ms:.4f} ms, bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it reached, "
              f"{bms / d_ms:.1%} by device time)", flush=True)
        rows[name].append(dict(ms=n * ms, device_ms=n * d_ms, plain_ms=n * p_ms, bound_ms=n * bms,
                               nbytes=n * nbytes, flops=n * ops, err=float(d.max().item())))
        del x, got, ref, d
    out = []
    for (line, c), name in zip(((72, 64), (96, 32)), ("glu_requant_one", "glu_requant_pair")):
        tot = sums(rows[name + "_f32"], keys=("ms", "device_ms", "plain_ms", "bound_ms", "nbytes",
                                              "flops"))
        tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"))[1]
        out.append({"name": name + "_f32", "route": "cuda",
                    "source": "tgsr_tpu_torch/csrc/glu_requant.cu",
                    "replaces": f"examples/glu_pallas_probe.py:{line}", **tot, "library_ms": None,
                    "shapes": f"B {B}, c {c}, float32 h, the sites of one int8 forward; "
                              "max_abs_err in int8 steps; ms, plain_ms by CUDA events (median "
                              "of five 20-call means), device_ms with the host's launches "
                              "queued behind a spin kernel"})
    return out


def requant_f32_phase(torch, sites=REQUANT_SITES, n_inputs=26, sweep=True):
    """The float32 instance of X2 (`requant` on float32 x) against
    `quantize_act` bit for bit: (with `sweep`) float32 over every binade
    from 2^-30 to 2^10 with the neighbours of every half-step, then the
    `n_inputs` requantized conv inputs (`sites`) of one B = 64 int8
    forward. Times as `requant_phase`."""
    from tgsr_tpu_torch.engine.quant import act_step
    from tgsr_tpu_torch.ops.glu_requant import requant, requant_plain

    g = torch.Generator(device="cuda").manual_seed(4)
    n = 1 << 22
    values = ((torch.rand(n, generator=g, device="cuda") + 1)
              * torch.exp2(torch.randint(-30, 11, (n,), generator=g, device="cuda").float())
              * (torch.randint(0, 2, (n,), generator=g, device="cuda").float() * 2 - 1))
    for scale in REQUANT_SCALES if sweep else ():
        half = ((torch.arange(-130, 130, device="cuda", dtype=torch.float64) + 0.5)
                * act_step(scale)).float()
        x = torch.cat([values, half, torch.nextafter(half, half + 1),
                       torch.nextafter(half, half - 1)])
        check(torch.equal(requant(x, scale), requant_plain(x, scale)),
              f"requant_f32 == quantize_act over {x.numel()} float32 (every binade 2^-30..2^10, "
              f"the half-steps and their neighbours), step {scale}/127")
    check(sum(n for *_, n in sites) == n_inputs,
          f"{n_inputs} requantized conv inputs a forward ({sum(n for *_, n in sites)})")
    rows = []
    for site, h, w, cin, k in sites:
        x = (torch.randn(B, h, w, cin, generator=g, device="cuda")
             * torch.rand(cin, generator=g, device="cuda") * 4)
        scale = 0.9 * x.abs().max().item()
        got, ref = requant(x, scale), requant_plain(x, scale)
        torch.cuda.synchronize()
        err = (got.int() - ref.int()).abs().max().item()
        check(torch.equal(got, ref), f"requant_f32 == quantize_act at {site} [{B},{h},{w},{cin}] "
                                     f"(max {err} step)")
        ms = cuda_ms_median(lambda: requant(x, scale))
        d_ms = device_ms(torch, lambda: requant(x, scale), iters=20)
        p_ms = cuda_ms_median(lambda: requant_plain(x, scale), iters=5)
        nbytes = 5 * x.numel()  # f32 in, int8 out
        ops = 4 * x.numel()
        bms, by = bound_ms(nbytes, ops)
        print(f"  requant_f32 {site} x{k}: kernel {ms:.4f} ms (device time {d_ms:.4f}), plain "
              f"{p_ms:.4f} ms, bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it reached, "
              f"{bms / d_ms:.1%} by device time)", flush=True)
        rows.append(dict(ms=k * ms, device_ms=k * d_ms, plain_ms=k * p_ms, bound_ms=k * bms,
                         nbytes=k * nbytes, flops=k * ops, err=float(err)))
    tot = sums(rows, keys=("ms", "device_ms", "plain_ms", "bound_ms", "nbytes", "flops"))
    tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"))[1]
    return {"name": "requant_f32", "route": "cuda", "source": "tgsr_tpu_torch/csrc/glu_requant.cu",
            "replaces": "tgsr_tpu/engine/quant.py:137 (quantize_act; XLA, no Pallas kernel)",
            **tot, "library_ms": None,
            "shapes": f"B {B}, float32 x, the {n_inputs} requantized conv inputs of one int8 "
                      f"forward ({len(sites)} shapes); "
                      "max_abs_err in int8 steps; ms, plain_ms by CUDA events (median of five "
                      "20-call means), device_ms with the host's launches queued behind a spin "
                      "kernel"}


def int8_conv_f32_phase(torch, convs=INT8_CONVS):
    """X1's float32 output, with a float32 residual at the ResBlock conv2
    sites (the int8 path with float32 compute), against its plain version
    bit for bit at every conv shape (`convs`) of one B = 64 int8 forward. Times as
    `int8_conv_phase` (no cuDNN beside it); the bound writes 4 bytes an
    output and reads a float32 residual."""
    from tgsr_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain, pack_int8_weight

    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for site, h, w, cin, cout, k, up2, bn, res, n in convs:
        ho, wo = (2 * h, 2 * w) if up2 else (h, w)
        x = torch.randint(-127, 128, (B, h, w, cin), generator=g, device="cuda",
                          dtype=torch.int8)
        wt = pack_int8_weight(torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                                            device="cuda", dtype=torch.int8))
        scale = torch.rand(cout, generator=g, device="cuda") * 1e-5 + 1e-6
        affine = ((1 + 0.1 * torch.randn(cout, generator=g, device="cuda"),
                   0.1 * torch.randn(cout, generator=g, device="cuda")) if bn else None)
        resid = torch.randn(B, ho, wo, cout, generator=g, device="cuda") if res else None
        args = (x, wt, scale, affine, resid, torch.float32, up2)
        got, ref = int8_conv(*args), int8_conv_plain(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(torch.equal(got, ref), f"int8_conv_f32 == plain at {site} [{B},{h},{w},{cin}]->"
                                     f"{cout} k{k}{' up2' if up2 else ''}"
                                     f"{' + f32 residual' if res else ''}: equal (max {err:.1e})")
        del got, ref
        ms = cuda_ms(lambda: int8_conv(*args), iters=3, warmup=1)
        d_ms = device_ms(torch, lambda: int8_conv(*args), iters=3, warmup=1)
        p_ms = cuda_ms(lambda: int8_conv_plain(*args), iters=1, warmup=0)
        nbytes = (x.numel() + k * k * cin * cout + 4 * cout * (3 if bn else 1)
                  + B * ho * wo * cout * (4 + (4 if res else 0)))  # f32 out [+ residual]
        ops = 2 * B * ho * wo * cout * k * k * cin
        bms, by = bound_ms(nbytes, ops, INT8_OP_PER_S)
        print(f"  int8_conv_f32 {site} x{n}: kernel {ms:.4f} ms (device time {d_ms:.4f}), plain "
              f"{p_ms:.4f} ms, bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it reached, "
              f"{bms / d_ms:.1%} by device time)", flush=True)
        rows.append(dict(ms=n * ms, device_ms=n * d_ms, plain_ms=n * p_ms, bound_ms=n * bms,
                         nbytes=n * nbytes, flops=n * ops, err=err))
    tot = sums(rows, keys=("ms", "device_ms", "plain_ms", "bound_ms", "nbytes", "flops"))
    tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"), INT8_OP_PER_S)[1]
    return {"name": "int8_conv_f32", "route": "cuda", "source": "tgsr_tpu_torch/csrc/int8_conv.cu",
            "replaces": "tgsr_tpu/engine/quant.py:164 (XLA int8 conv; no Pallas kernel)",
            **tot, "library_ms": None,
            "shapes": f"B {B}, the {sum(c[-1] for c in convs)} convs of one int8 forward "
                      f"({len(convs)} shapes) with a float32 output, a float32 residual at the "
                      f"{sum(c[-1] for c in convs if c[8])} ResBlock conv2s; ms, plain_ms by "
                      "CUDA events, device_ms with the host's launches queued behind a spin "
                      "kernel"}


def ptxas_entries(log: str) -> list:
    """[(mangled entry name, {registers, stack and spill bytes})] of every
    kernel instance in a `ptxas -v` log, in the log's order."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        usage = {}
        for nxt in lines[i + 1:i + 6]:
            if "spill stores" in nxt:
                nums = [int(w) for w in nxt.replace(",", " ").split() if w.isdigit()]
                usage["stack_bytes"], usage["spill_store_bytes"], usage["spill_load_bytes"] = \
                    nums[:3]
            elif "Used" in nxt and "registers" in nxt:
                usage["registers"] = int(nxt.split("Used")[1].split()[0])
        out.append((line.split("'")[1], usage))
    return out


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers and spill bytes of `kernel` in a `ptxas -v` log."""
    return next(u for name, u in ptxas_entries(log) if kernel in name)


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

        kern.sr_batched(lr, cap, lens, microbatch=mb)  # captures the graph at B = 64
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = kern.sr_batched(lr, cap, lens, microbatch=mb)
        dt = time.perf_counter() - t0
        eager, replayed = dict(_build.LAUNCHES), dict(_build.REPLAYED)
        launches[tag] = {key: eager[key] + replayed[key] for key in eager}
        m, b = kern.plan_batches(n, mb)
        want = {key: v * m for key, v in per_forward.items()}
        check(eager == zero and replayed == want,
              f"sr_batched {tag} N={n} microbatch {mb}: {m} replays of the graph captured at "
              f"B = {b} went through the kernels (replayed {replayed}, eager {eager})")
        check(out.shape == (n, 256, 256, 3) and out.dtype.name == "uint8" and out.std() > 1,
              f"sr_batched {tag} output uint8 {out.shape}")
        print(f"  sr_batched {tag} N={n} microbatch {mb}: {dt:.4f} s, {n / dt:.2f} img/s "
              f"(seeded weights) on {card}", flush=True)
        lr_d, cap_d, lens_d = (torch.as_tensor(x[:mb], device="cuda") for x in (lr, cap, lens))
        profile_forward(torch, lambda: kern._serve(lr_d, cap_d, lens_d), tag, "eager", mb)
        profile_forward(torch, lambda: kern.forward_scan(lr[None, :mb], cap[None, :mb],
                                                         lens[None, :mb]), tag, "replay", mb)
        if tag == "bfloat16":
            t0 = time.perf_counter()
            scales = kern.calibrate_quant(lrc.astype("float32") / 127.5 - 1.0, capc, lensc)
            print(f"  calibrate_quant on the card, B=16: {time.perf_counter() - t0:.1f} s, "
                  f"{sum(len(v) for v in scales.values())} scales", flush=True)
        del kern
    return launches, scales


def x16_inputs(torch):
    """The x16 phase's configuration, weights and inputs, drawn from seed 16
    alone (the same on any machine that runs the phase, or rehearses it on
    the CPU): cfg from configs/eval_faceSR_S16.yml, init_seeded weights at
    that full width, two eval images with mixed caption lengths (one
    empty) and eight calibration images, uint8 LR at 32 px."""
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import config_from_file

    cfg = config_from_file(os.path.join(HERE, "configs", "eval_faceSR_S16.yml"))
    rng = np.random.default_rng(16)
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(16))

    def batch(n):
        lr = rng.integers(0, 256, (n, 32, 32, 3)).astype("uint8")
        lens = rng.integers(1, T + 1, n)
        lens[min(1, n - 1)] = 0
        cap = rng.integers(1, 41, (n, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        return lr, cap, lens

    return cfg, sds, batch(2), batch(8), rng


def tf32_effect(torch, card):
    """What TF32 does to the float32 serving path (ROADMAP C 5): the face S8
    float32 SRPipeline with pipeline_phase's seeded weights serves one batch
    of B = 64 seeded requests eagerly with cuDNN's and cuBLAS's TF32
    switches on (PyTorch's default for cuDNN), then off, both set after the
    build (a float32 pipeline built on the card turns them off), restored
    after. Prints the uint8 PSNR of the first SR against the second, the
    largest difference in uint8 levels, the share of values that differ and
    the largest float difference."""
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8

    cfg, n = face_s8_config(), 64
    pipe = SRPipeline(cfg, 41, *init_seeded(cfg, 41, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    lr = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.float32) / 127.5 - 1.0
    lens = rng.integers(0, T + 1, n)
    cap = rng.integers(1, 41, (n, T))
    cap[np.arange(T)[None, :] >= lens[:, None]] = 0
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    sr = {}
    try:
        for on in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
            sr[on] = pipe(lr, cap, lens)["sr"].float().cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    d = (to_uint8(sr[True]).int() - to_uint8(sr[False]).int()).abs()
    mse = d.double().square().mean().item()
    psnr = float("inf") if mse == 0 else 10 * float(np.log10(255.0 ** 2 / mse))
    print(f"  tf32 effect: float32 SR with TF32 on against TF32 off, face S8 seeded weights, "
          f"B = {n}: uint8 PSNR {psnr:.2f} dB, max {int(d.max())} levels, "
          f"{float((d > 0).double().mean()):.4%} of values differ, max abs err "
          f"{float((sr[True] - sr[False]).abs().max()):.3e}, on {card}", flush=True)


def x16_phase(torch, card, tmp, clients):
    """The x16 family served end to end at full width (configs/eval_faceSR_S16
    .yml: BRANCH_NUM 5, 32 px -> 512 px, GF_DIM 32, R_NUM 2, EMBEDDING_DIM
    256, T 18; seeded weights, `x16_inputs`), through the same entry points
    as x8: float32 on the card against the same pipeline on the CPU (max
    abs error <= 1e-3, uint8 within 1); bfloat16 >= 40 dB against it; int8
    with scales calibrated on the card (calibrate_quant, eight images) >= 40
    dB against the same int8 pipeline on the CPU and >= X16_INT8_PSNR_FLOOR
    against float32 on the CPU; int8 with float32 compute >= 40 dB against
    its CPU twin. Per path: one eager forward's launches (X16_PER_FORWARD),
    sr_batched at N = 32 in microbatches of 16 (two graph replays, their
    launches the path's count in the kernels line), the replay at B = 16 bit
    for bit the eager forward, the plan (bfloat16: sr_batched at N = plan
    and plan + 1 under its budget) and a profile of one forward at B =
    min(64, plan), eager and under replay. Then the HTTP server booted from
    configs/eval_faceSR_S16.yml, x16 .pth files and the shipped NET_E
    answering 512 px POSTs. Returns the launches of each run."""
    from tgsr_tpu_torch.checkpoints.shipped import shipped_net_e
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.engine.quant import x16_scales
    from tgsr_tpu_torch.ops import _build

    cfg, sds, (lr, cap, lens), (lrc, capc, lensc), rng = x16_inputs(torch)
    check(cfg.TREE.BRANCH_NUM == 5 and cfg.imsize == 512 and cfg.GAN.GF_DIM == 32,
          f"x16: configs/eval_faceSR_S16.yml is BRANCH_NUM {cfg.TREE.BRANCH_NUM}, "
          f"{cfg.TREE.BASE_SIZE} -> {cfg.imsize} px, GF_DIM {cfg.GAN.GF_DIM}")
    lrf = lr.astype("float32") / 127.5 - 1.0
    t0 = time.perf_counter()
    ref = SRPipeline(cfg, 41, *sds, device="cpu")(lrf, cap, lens)["sr"]
    print(f"  x16 plain reference on the CPU, B=2: {time.perf_counter() - t0:.1f} s", flush=True)
    zero = {name: 0 for name in _build.LAUNCH_NAMES}
    n, mb = 32, 16
    lr_n, cap_n, lens_n = (np.concatenate([x] * (n // 2)) for x in (lr, cap, lens))
    launches, scales = {}, None
    for tag in ("float32", "bfloat16", "int8", "int8 f32"):
        per_forward = dict(zero, word_pixel_attention=4, **X16_PER_FORWARD[tag])
        kw = dict(compute_dtype=torch.float32 if tag in ("float32", "int8 f32")
                  else torch.bfloat16)
        if tag.startswith("int8"):
            kw["quant_scales"] = scales
        kern = SRPipeline(cfg, 41, *sds, device="cuda", **kw)
        _build.reset_launches()
        got = kern(lrf, cap, lens)["sr"]
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        check(counts == per_forward, f"x16: one {tag} forward launches {per_forward} ({counts})")
        check(tuple(got.shape) == (2, 512, 512, 3) and bool(torch.isfinite(got).all())
              and float(got.std()) > 1e-3,
              f"x16 {tag} SR is finite, not constant, shape {tuple(got.shape)}")
        du8 = (to_uint8(got).cpu().int() - to_uint8(ref).int()).abs().max().item()
        if tag == "float32":
            err = (got.cpu() - ref).abs().max().item()
            check(err <= 1e-3 and du8 <= 1, f"x16 f32: the card's kernels == plain on the CPU "
                                             f"(max abs err {err:.3e} <= 1e-3, uint8 within "
                                             f"{du8} <= 1)")
        elif tag == "bfloat16":
            psnr = psnr_u8(got, ref)
            check(psnr >= 40, f"x16 bf16 on the card vs f32 plain on the CPU: uint8 PSNR "
                              f"{psnr:.2f} dB >= 40 (max {du8} levels)")
        else:
            t0 = time.perf_counter()
            cref = SRPipeline(cfg, 41, *sds, device="cpu", **kw)(lrf, cap, lens)["sr"]
            print(f"  x16 {tag} plain reference on the CPU, B=2: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            psnr_cpu = psnr_u8(got, cref)
            check(psnr_cpu >= 40, f"x16 {tag} on the card vs {tag} plain on the CPU, same "
                                  f"scales: uint8 PSNR {psnr_cpu:.2f} dB >= 40")
            psnr = psnr_u8(got, ref)
            print(f"  x16 {tag} vs f32, both on the CPU (B=2): uint8 PSNR "
                  f"{psnr_u8(cref, ref):.2f} dB", flush=True)
            if tag == "int8":
                check(psnr >= X16_INT8_PSNR_FLOOR, f"x16 int8 on the card vs f32 plain on the "
                                                   f"CPU: PSNR {psnr:.2f} dB >= "
                                                   f"{X16_INT8_PSNR_FLOOR}")

        kern.sr_batched(lr_n, cap_n, lens_n, microbatch=mb)  # captures the graph at B = 16
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = kern.sr_batched(lr_n, cap_n, lens_n, microbatch=mb)
        dt = time.perf_counter() - t0
        eager, replayed = dict(_build.LAUNCHES), dict(_build.REPLAYED)
        launches[f"x16 {tag}"] = {key: eager[key] + replayed[key] for key in eager}
        check(eager == zero and replayed == {k: 2 * v for k, v in per_forward.items()},
              f"x16 sr_batched {tag} N={n} microbatch {mb}: 2 replays of the graph at B = {mb} "
              f"went through the kernels (replayed {replayed}, eager {eager})")
        with torch.inference_mode():
            lr_d = torch.as_tensor(lr_n[:mb], device="cuda").float() / 127.5 - 1.0
            same = to_uint8(kern(lr_d, cap_n[:mb], lens_n[:mb])["sr"]).cpu().numpy()
        check(out.shape == (n, 512, 512, 3) and np.array_equal(out[:mb], same),
              f"x16 {tag}: sr_batched at B = {mb} (graph replay) == uint8 of the eager "
              f"__call__, bit for bit ({int((out[:mb] != same).sum())} values differ)")
        print(f"  x16 sr_batched {tag} N={n} microbatch {mb}: {dt:.4f} s, {n / dt:.2f} img/s "
              f"(seeded weights) on {card}", flush=True)
        b_plan = kern.plan_microbatch()
        plan = kern.memory_plan
        print(f"  x16 {tag} plan_microbatch: {b_plan} (need {plan.fixed_bytes} + "
              f"{plan.per_image_bytes} x b bytes, held by other graphs "
              f"{plan.held_per_image_bytes} x b, probes {plan.probes}, budget "
              f"{plan.budget_bytes} bytes) on {card}", flush=True)
        if tag != "int8 f32":
            bp = min(64, b_plan)
            sel = np.arange(bp) % n
            lr_p, cap_p, lens_p = lr_n[sel], cap_n[sel], lens_n[sel]
            lr_d, cap_d, lens_d = (torch.as_tensor(x, device="cuda") for x in (lr_p, cap_p,
                                                                              lens_p))
            profile_forward(torch, lambda: kern._serve(lr_d, cap_d, lens_d), f"x16 {tag}",
                            "eager", bp)
            for _ in range(4):  # the capture at bp, then replays before the one profiled
                kern.forward_scan(lr_p[None], cap_p[None], lens_p[None])
            profile_forward(torch, lambda: kern.forward_scan(lr_p[None], cap_p[None],
                                                             lens_p[None]),
                            f"x16 {tag}", "replay", bp)
        if tag == "bfloat16":
            torch.cuda.empty_cache()
            base = torch.cuda.memory_reserved()
            for n_big in (b_plan, b_plan + 1):
                sel = np.arange(n_big) % n
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                big = kern.sr_batched(lr_n[sel], cap_n[sel], lens_n[sel])
                dt = time.perf_counter() - t0
                peak = torch.cuda.max_memory_reserved() - base
                m, b = kern.plan_batches(n_big, b_plan)
                check(big.shape == (n_big, 512, 512, 3) and peak <= plan.budget_bytes,
                      f"x16 bf16: sr_batched(microbatch=None) at N = {n_big} ({m} x {b}, graph "
                      f"at {kern.graph_batch(b)}, capture included, {dt:.2f} s) peaked at {peak} "
                      f"reserved bytes ({peak / 2 ** 30:.2f} GiB) <= the budget "
                      f"{plan.budget_bytes}")
                del big
            t0 = time.perf_counter()
            scales = kern.calibrate_quant(lrc.astype("float32") / 127.5 - 1.0, capc, lensc)
            print(f"  x16 calibrate_quant on the card, B=8: {time.perf_counter() - t0:.1f} s, "
                  f"{sum(len(v) for v in scales.values())} scales", flush=True)
            check(all(sorted(scales[g]) == sorted(v) for g, v in x16_scales().items()
                      if g != "_meta"),
                  f"x16: calibrate_quant keys the tied stage and head once, under h_net2 and "
                  f"img_net1 ({len(scales['netg'])} netg, {len(scales['netgh'])} netgh scales)")
        del kern
        gc.collect()
        torch.cuda.empty_cache()

    # the HTTP server booted from the repository's S16 YAML; its NET_E is a
    # path outside the checkout, so the shipped one is named by flag
    paths = [os.path.join(tmp, name) for name in ("netG_epoch_7.pth", "netGH_epoch_7.pth")]
    for path, sd in zip(paths, sds[1:3]):
        torch.save(sd, path)
    words = dict(enumerate(FACE_WORDS))
    with open(os.path.join(tmp, "testset.pickle"), "wb") as f:
        pickle.dump([[], words, {w: i for i, w in words.items()}], f)
    argv = ["--cfg", os.path.join(HERE, "configs", "eval_faceSR_S16.yml"), "--netg", paths[0],
            "--vocab_pickle", os.path.join(tmp, "testset.pickle"), "--text_encoder",
            shipped_net_e(41), "--max_batch", "16"]
    pipe, _, launches["x16 http"] = serve_and_post(torch, rng, card, clients, argv, 4, 4, 1,
                                                   "x16 bf16")
    check(pipe.cfg.imsize == 512 and launches["x16 http"]["word_pixel_attention"] > 0
          and launches["x16 http"]["up_head_packed"] > 0,
          f"x16 http: served from configs/eval_faceSR_S16.yml at 512 px through rows 1 and 3 "
          f"({launches['x16 http']})")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def x16_kernel_phase(torch, rng):
    """The kernels of the x16 path at its shapes (B = 64, one x16 forward's
    sites: X16_ATTENTION, UP_HEAD_SITES_X16, GLU_SITES_X16,
    REQUANT_SITES_X16, INT8_CONVS_X16), each held against its plain version
    with the gates of the x8 phases; the int8 rows in both instances, the
    bfloat16 one and the float32 one that int8 with float32 compute runs
    (whose conv stages its tiles for a float32 output). Returns {kernel name: its numbers},
    which main sets under "x16" in that kernel's entry."""
    entries = [attention_phase(torch, rng, X16_ATTENTION),
               *up_head_phase(torch, 256, UP_HEAD_SITES_X16),
               *glu_requant_phase(torch, GLU_SITES_X16, sweep=False),
               requant_phase(torch, REQUANT_SITES_X16, 35, sweep=False),
               int8_conv_phase(torch, INT8_CONVS_X16),
               *glu_requant_f32_phase(torch, GLU_SITES_X16),
               requant_f32_phase(torch, REQUANT_SITES_X16, 35, sweep=False),
               int8_conv_f32_phase(torch, INT8_CONVS_X16)]
    return {e["name"]: {k: v for k, v in e.items() if k not in ("name", "route", "source",
                                                                 "replaces")}
            for e in entries}


def percentiles(ms) -> str:
    return f"p50 {np.percentile(ms, 50):.4f} ms, p99 {np.percentile(ms, 99):.4f} ms"


def serving_phase(torch, rng, card, scales):
    """The serving engine at face S8 full width, seeded weights, per path
    (float32, bfloat16, int8 with the calibrated scales): sr_batched at
    B = 64 (graph replay) bit for bit the uint8 of the eager __call__, its
    launches the captured counts times the replays; sr_arbitrary at ragged
    LR shapes (40 x 56 native, 36 x 52 in buckets of 64) against the plain
    pipelines on the CPU; B = 1 latency and img/s, eager against replay; the
    memory plan (bf16: sr_batched(microbatch=None) at N = plan and plan + 1,
    their peak reserved bytes under its budget); an int8 bundle and a .pth checkpoint round trip; BatchingServer
    (bf16). Returns the kernel launches of its runs."""
    import tempfile

    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.ops import _build

    cfg = face_s8_config()
    vocab, s = 41, cfg.scale
    sds = init_seeded(cfg, vocab, torch.Generator().manual_seed(0))
    zero = {name: 0 for name in _build.LAUNCH_NAMES}

    def captions(n):
        lens = rng.integers(1, T + 1, n)
        lens[0] = 0  # an empty caption
        cap = rng.integers(1, vocab, (n, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        return cap, lens

    lr64 = rng.integers(0, 256, (64, 32, 32, 3)).astype("uint8")
    cap64, lens64 = captions(64)
    lr1 = lr64[:1].astype("float32") / 127.5 - 1.0
    # ragged LR: (h, w, bucket); the CPU references, every kernel site plain
    ragged = [(40, 56, None), (36, 52, 64)]
    ragged_lr = {(h, w): rng.integers(0, 256, (1, h, w, 3)).astype("float32") / 127.5 - 1.0
                 for h, w, _ in ragged}
    cap_r, lens_r = captions(1)
    cap_r[0, :5], lens_r[0] = rng.integers(1, vocab, 5), 5

    def padded(lr, bucket):
        if not bucket:
            return lr
        bh, bw = -(-lr.shape[1] // bucket) * bucket, -(-lr.shape[2] // bucket) * bucket
        return np.pad(lr, ((0, 0), (0, bh - lr.shape[1]), (0, bw - lr.shape[2]), (0, 0)),
                      mode="edge")

    def cpu_refs(**kw):
        pipe = SRPipeline(cfg, vocab, *sds, device="cpu", **kw)
        return {(h, w): pipe(padded(ragged_lr[h, w], bk), cap_r, lens_r)["sr"][:, :h * s, :w * s]
                for h, w, bk in ragged}

    t0 = time.perf_counter()
    ref_f32 = cpu_refs()
    ref_int8 = cpu_refs(compute_dtype=torch.bfloat16, quant_scales=scales)
    print(f"  serving: ragged references on the CPU (f32 and int8): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = {}
    for tag in ("float32", "bfloat16", "int8"):
        per_forward = dict(zero, word_pixel_attention=3)
        per_forward.update({"float32": {"up_head": 2}, "bfloat16": {"up_head_packed": 2},
                            "int8": {"int8_conv": 42, "glu_requant_one": 6,
                                     "glu_requant_pair": 10, "requant": 26}}[tag])
        kw = dict(compute_dtype=torch.float32 if tag == "float32" else torch.bfloat16)
        if tag == "int8":
            kw["quant_scales"] = scales
        kern = SRPipeline(cfg, vocab, *sds, device="cuda", **kw)
        run = dict(zero)

        def count():
            for key in run:
                run[key] += _build.LAUNCHES[key] + _build.REPLAYED[key]

        # 1. replay against eager, B = 64
        kern.sr_batched(lr64, cap64, lens64, microbatch=64)  # captures
        _build.reset_launches()
        out = kern.sr_batched(lr64, cap64, lens64, microbatch=64)
        torch.cuda.synchronize()
        graph = kern.graphs[(64, 32, 32, T, torch.uint8)]
        check(_build.LAUNCHES == zero and _build.REPLAYED == per_forward == dict(graph.launches),
              f"serving {tag}: one replay at B = 64 launched the captured counts "
              f"({_build.REPLAYED}) and nothing eagerly")
        count()
        with torch.inference_mode():
            lr_f = torch.as_tensor(lr64, device="cuda").float() / 127.5 - 1.0
            eager = to_uint8(kern(lr_f, cap64, lens64)["sr"]).cpu().numpy()
        check(np.array_equal(out, eager), f"serving {tag}: sr_batched at B = 64 (graph replay) "
                                          f"== uint8 of the eager __call__, bit for bit "
                                          f"({int((out != eager).sum())} values differ)")

        # 2. ragged shapes, eager
        for h, w, bucket in ragged:
            lr_r = ragged_lr[h, w]
            _build.reset_launches()
            got = kern.sr_arbitrary(lr_r, cap_r, lens_r, bucket=bucket)
            torch.cuda.synchronize()
            check(_build.LAUNCHES == per_forward and _build.REPLAYED == zero,
                  f"serving {tag}: sr_arbitrary {h}x{w} bucket {bucket} went through the "
                  f"kernels eagerly ({_build.LAUNCHES})")
            count()
            check(got.shape == (1, h * s, w * s, 3), f"serving {tag}: sr_arbitrary {h}x{w} "
                                                     f"bucket {bucket} shape {got.shape}")
            ref = (ref_int8 if tag == "int8" else ref_f32)[h, w]
            ref_u8 = to_uint8(ref).numpy().astype(int)
            if tag == "float32":
                got_f = kern(padded(lr_r, bucket), cap_r, lens_r)["sr"][:, :h * s, :w * s].cpu()
                err = (got_f - ref).abs().max().item()
                du8 = np.abs(got.astype(int) - ref_u8).max()
                check(err <= 1e-3 and du8 <= 1,
                      f"serving f32: sr_arbitrary {h}x{w} bucket {bucket} == plain on the CPU "
                      f"(max abs err {err:.3e} <= 1e-3, uint8 within {du8} <= 1)")
            else:
                mse = max(float(np.mean((got.astype(int) - ref_u8) ** 2)), 1e-12)
                psnr = 10 * np.log10(255.0 ** 2 / mse)
                what = "int8 plain on the CPU, same scales" if tag == "int8" else "f32 plain"
                check(psnr >= 40, f"serving {tag}: sr_arbitrary {h}x{w} bucket {bucket} (its "
                                  f"uint8 output) vs {what}: PSNR {psnr:.2f} dB >= 40")

        # 3. bundles and checkpoints
        with tempfile.TemporaryDirectory() as tmp:
            if tag == "int8":
                kern.save_artifact(os.path.join(tmp, "bundle"))
                loaded, _ = SRPipeline.load_artifact(os.path.join(tmp, "bundle"), device="cuda")
                same = loaded.sr_batched(lr64, cap64, lens64, microbatch=64)
                check(np.array_equal(same, out), "serving int8: save_artifact -> load_artifact "
                                                 "on the card gives the same output bit for bit")
                del loaded
            if tag == "bfloat16":
                paths = [os.path.join(tmp, name) for name in
                         ("text_encoder.pth", "netG_epoch_7.pth", "netGH_epoch_7.pth")]
                for path, sd in zip(paths, sds):
                    torch.save(sd, path)
                loaded = SRPipeline.from_reference_checkpoints(
                    cfg, vocab, paths[1], text_encoder_path=paths[0], device="cuda", **kw)
                same = loaded.sr_batched(lr64, cap64, lens64, microbatch=64)
                check(np.array_equal(same, out), "serving bf16: .pth checkpoints through "
                                                 "from_reference_checkpoints give the same "
                                                 "output bit for bit")
                del loaded

        # 4. one request at B = 1 and img/s, eager against replay
        def eager_one():
            with torch.inference_mode():
                return to_uint8(kern(lr1, cap64[:1], lens64[:1])["sr"]).cpu().numpy()

        def replay_one():
            return kern.sr_uint8(lr1, cap64[:1], lens64[:1])

        lat = {}
        for how, fn in (("eager", eager_one), ("replay", replay_one)):
            fn()
            ms = []
            for _ in range(50):
                t0 = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t0) * 1e3)
            lat[how] = ms
        check(np.array_equal(eager_one(), replay_one()),
              f"serving {tag}: sr_uint8 at B = 1 (replay) == eager, bit for bit")
        print(f"  serving {tag} one request at B = 1 (50 requests, host clock, seeded weights): "
              f"eager {percentiles(lat['eager'])}; replay {percentiles(lat['replay'])} "
              f"on {card}", flush=True)
        # float32 is device-bound (eager and replay within 2 %, PERF.md), so
        # fewer images measure its rate
        n_img = 256 if tag == "float32" else 1024
        m_img = n_img // 64
        lr_n = rng.integers(0, 256, (n_img, 32, 32, 3)).astype("uint8")
        cap_n, lens_n = captions(n_img)

        def eager_batched():
            with torch.inference_mode():
                lr_d, cap_d, lens_d = (torch.as_tensor(x, device="cuda").reshape(m_img, 64,
                                                                                  *x.shape[1:])
                                       for x in (lr_n, cap_n, lens_n))
                return torch.stack([kern._serve(lr_d[i], cap_d[i], lens_d[i])
                                    for i in range(m_img)]).cpu().numpy()

        def replay_batched():
            return kern.sr_batched(lr_n, cap_n, lens_n, microbatch=64)

        def replay_on_card():  # the same replays, the uint8 SR left on the card
            kern.forward_scan(lr_n.reshape(m_img, 64, 32, 32, 3), cap_n.reshape(m_img, 64, T),
                              lens_n.reshape(m_img, 64))
            torch.cuda.synchronize()

        rate = {}
        for how, fn in (("eager", eager_batched), ("replay", replay_batched),
                        ("replay_on_card", replay_on_card)):
            fn()
            t0 = time.perf_counter()
            fn()
            rate[how] = n_img / (time.perf_counter() - t0)
        print(f"  serving {tag} sr_batched N = {n_img}, microbatch 64: eager {rate['eager']:.2f} "
              f"img/s, replay {rate['replay']:.2f} img/s (without the copy of the SR to the "
              f"host: {rate['replay_on_card']:.2f}) (seeded weights) on {card}", flush=True)
        profile_forward(torch, replay_one, tag, "replay", 1, top=4)

        # 5. the memory plan
        b_plan = kern.plan_microbatch()
        plan = kern.memory_plan
        print(f"  serving {tag} plan_microbatch: {b_plan} (need {plan.fixed_bytes} + "
              f"{plan.per_image_bytes} x b bytes, held by other graphs "
              f"{plan.held_per_image_bytes} x b, probes {plan.probes}, budget "
              f"{plan.budget_bytes} bytes, {plan.budget_bytes / 2 ** 30:.2f} GiB) on {card}",
              flush=True)
        if tag == "bfloat16":
            # one microbatch at the plan, then plan + 1 (two of about half):
            # the allocator's peak reserved bytes, above what it reserved
            # after the plan, held to the plan's budget
            torch.cuda.empty_cache()
            base = torch.cuda.memory_reserved()
            for n_big in (b_plan, b_plan + 1):
                lr_b = rng.integers(0, 256, (n_big, 32, 32, 3)).astype("uint8")
                cap_b, lens_b = captions(n_big)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                big = kern.sr_batched(lr_b, cap_b, lens_b)
                dt = time.perf_counter() - t0
                peak = torch.cuda.max_memory_reserved() - base
                m, b = kern.plan_batches(n_big, b_plan)
                check(big.shape == (n_big, 256, 256, 3) and peak <= plan.budget_bytes,
                      f"serving bf16: sr_batched(microbatch=None) at N = {n_big} ({m} x {b}, "
                      f"graph at {kern.graph_batch(b)}, capture included, {dt:.2f} s) peaked at "
                      f"{peak} reserved bytes ({peak / 2 ** 30:.2f} GiB) <= the budget "
                      f"{plan.budget_bytes}")
                del big

        # 6. BatchingServer
        if tag == "bfloat16":
            server_checks(torch, kern, card, rng, captions, per_forward, run)
        launches[tag] = run
        del kern
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def server_checks(torch, kern, card, rng, captions, per_forward, run) -> None:
    """BatchingServer (max_batch 64) after warmup(): 8 threads submit 256
    requests; each result within 2 uint8 levels of its B = 1 result (the
    bf16 row gate of the pipeline phase)."""
    import threading

    from tgsr_tpu_torch.engine.serving import BatchingServer
    from tgsr_tpu_torch.ops import _build

    n = 256
    lrs = rng.integers(0, 256, (n, 32, 32, 3)).astype("float32") / 127.5 - 1.0
    caps, lens = captions(n)
    results = [None] * n
    with BatchingServer(kern, max_batch=64, max_delay_ms=5) as server:
        t0 = time.perf_counter()
        server.warmup(lr_shape=(32, 32, 3))
        print(f"  serving bf16 BatchingServer warmup (graphs at {server.planned_sizes}): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        _build.reset_launches()

        def worker(k):
            futs = [(i, server.submit(lrs[i], caps[i], lens[i])) for i in range(k, n, 8)]
            for i, fut in futs:
                results[i] = fut.result(timeout=300)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        dt = time.perf_counter() - t0
        stats = server.stats_snapshot()
        pct = server.latency_percentiles()
    replayed = dict(_build.REPLAYED)
    batches = stats["batches"]
    for key in run:
        run[key] += _build.LAUNCHES[key] + replayed[key]
    check(not any(t.is_alive() for t in threads) and stats["requests"] == n
          and _build.LAUNCHES == {k: 0 for k in run}
          and replayed == {k: v * batches for k, v in per_forward.items()},
          f"serving bf16 BatchingServer: {stats['requests']} of {n} requests in {batches} "
          f"graph replays, nothing eager")
    worst = 0
    for i in range(n):
        one = kern.sr_uint8(lrs[i:i + 1], caps[i:i + 1], lens[i:i + 1])[0]
        worst = max(worst, int(np.abs(one.astype(int) - results[i].astype(int)).max()))
    check(worst <= 2, f"serving bf16 BatchingServer: every result within 2 uint8 levels of "
                      f"its B = 1 result (max {worst})")
    print(f"  serving bf16 BatchingServer, 8 threads x 32 requests: {dt:.3f} s, "
          f"{n / dt:.2f} img/s, batch histogram {dict(sorted(stats['batch_hist'].items()))}, "
          f"latency p50 {pct['p50_ms']:.4f} ms, p99 {pct['p99_ms']:.4f} ms (host clock, "
          f"seeded weights) on {card}", flush=True)


# a 41-word caption vocabulary of the face S8 size (the shipped NET_E's)
FACE_WORDS = ("<end> the this a woman man person has have is wears wearing with and "
              "black blond brown gray red straight wavy short long hair big pointy small nose "
              "lips mouth slightly open smiling eyes narrow bags under arched eyebrows high "
              "cheekbones").split()
# the bfloat16 pipeline's mean Y-PSNR and Y-SSIM against the HR, off the
# float32 pipeline's on the CPU by at most these: about twice the gaps read on
# an H100 (0.0073 dB, 1.4-1.5e-4; PERF.md), so that an error of a few levels
# more than bfloat16's fails
EVAL_BF16_PSNR_GAP_DB = 0.015
EVAL_BF16_SSIM_GAP = 3e-4
FACE_S8_YAML = """# face S8 evaluation: x8, 32 px -> 256 px (the reference's eval_faceSR_attn2.yml)
CONFIG_NAME: 'face_S8_eval'
METHOD: 'S8'
TREE:
    BRANCH_NUM: 4  # x8
    BASE_SIZE: 32
DATASET_NAME: 'face'
B_VALIDATION: True
TRAIN:
    FLAG: False
    NET_G: 'netG_epoch_7.pth'
    B_NET_D: True
    BATCH_SIZE: 1
    NET_E: '{absent_net_e}'  # absent: falls through to the shipped NET_E
GAN:
    DF_DIM: 64
    GF_DIM: 32
    Z_DIM: 100
    R_NUM: 2
TEXT:
    EMBEDDING_DIM: 256
    CAPTIONS_PER_IMAGE: 1
"""


def face_captions(rng, n):
    """n caption strings of 3-18 words from FACE_WORDS (at most T tokens, so
    that the server draws no random subsample)."""
    return [" ".join(rng.choice(FACE_WORDS[1:], rng.integers(3, T + 1))) for _ in range(n)]


def concurrency_phase(torch, rng, card):
    """One bfloat16 pipeline at face S8 full width shared by three threads:
    two threads x 16 sr_uint8 calls with different inputs at the same graph
    keys (B = 1 and B = 3, which replays at 4), a third thread's
    sr_arbitrary calls (40 x 56, bucket 64) at the same time, and one call
    that captures a new key (B = 2) while the others run; every result bit
    for bit the same call run alone afterwards. Returns its launches."""
    import threading

    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.ops import _build

    cfg = face_s8_config()
    pipe = SRPipeline(cfg, 41, *init_seeded(cfg, 41, torch.Generator().manual_seed(0)),
                      device="cuda", compute_dtype=torch.bfloat16)

    def inputs(b, h=32, w=32):
        lr = rng.integers(0, 256, (b, h, w, 3)).astype("float32") / 127.5 - 1.0
        lens = rng.integers(1, T + 1, b)
        cap = rng.integers(1, 41, (b, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        return lr, cap, lens

    jobs = {}
    for k in range(2):
        for i in range(16):
            b = 2 if (k, i) == (0, 8) else 1 + 2 * (i % 2)
            jobs[k, i] = ("sr_uint8", *inputs(b))
    for i in range(4):
        jobs[2, i] = ("sr_arbitrary", *inputs(1, 40, 56))

    def run(job):
        name, lr, cap, lens = job
        kw = {"bucket": 64} if name == "sr_arbitrary" else {}
        return getattr(pipe, name)(lr, cap, lens, **kw)

    run(jobs[0, 0])  # the B = 1 graph, before the threads start
    run(jobs[0, 1])  # and B = 3's at 4
    got, errors = {}, []
    start = threading.Barrier(3)

    def worker(k):
        try:
            start.wait(60)
            for key in sorted(j for j in jobs if j[0] == k):
                got[key] = run(jobs[key])
        except Exception as e:  # reported by the check below
            errors.append(f"thread {k}: {e!r}")

    _build.reset_launches()
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    run_counts = {key: _build.LAUNCHES[key] + _build.REPLAYED[key] for key in _build.LAUNCHES}
    check(not any(t.is_alive() for t in threads) and not errors,
          f"concurrency: three threads on one bf16 pipeline finished without an error "
          f"({errors or 'none'}) in {dt:.2f} s")
    check(sorted(key[0] for key in pipe.graphs) == [1, 2, 4],
          f"concurrency: graphs at B = 1, 2 (captured while the others ran) and 4 "
          f"({sorted(key[0] for key in pipe.graphs)})")
    differ = [key for key, job in jobs.items() if not np.array_equal(got.get(key), run(job))]
    check(not differ, f"concurrency: every one of {len(jobs)} results bit for bit the same call "
                      f"run alone (differ: {differ})")
    check(run_counts["word_pixel_attention"] > 0 and run_counts["up_head_packed"] > 0,
          f"concurrency: went through rows 1 and 3 ({run_counts})")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return run_counts


# launches of one forward per serving path (pipeline_phase's per_forward)
PATH_KERNELS = {"float32": {"word_pixel_attention": 3, "up_head": 2},
                "bfloat16": {"word_pixel_attention": 3, "up_head_packed": 2},
                "int8": {"word_pixel_attention": 3, "int8_conv": 42, "glu_requant_one": 6,
                         "glu_requant_pair": 10, "requant": 26}}
# what a process that loads an exported program may import of the repo
AOT_LOADER = r"""
import sys
import numpy as np
from tgsr_tpu_torch.engine.aot import AOTPipeline
d = np.load(sys.argv[2])
out = AOTPipeline(sys.argv[1]).sr_uint8(d["lr"], d["cap"], d["lens"])
np.save(sys.argv[3], out)
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("tgsr_tpu", "tgsr_tpu_torch"))
print("AOT_LOADER_MODULES " + " ".join(mods), flush=True)
"""


def aot_phase(torch, rng, card, scales, tmp):
    """The export entry points on the card (engine/aot.py, cli/export_aot.py,
    cli/serve.py --aot). The face S8 pipeline at full width, seeded weights,
    in float32, bfloat16 and int8 (pipeline_phase's scales) is exported with a
    symbolic batch, saved and loaded as an AOTPipeline; its sr_uint8 at B = 1,
    3 and 64 (a replay at graph_batch(B)) equals the live SRPipeline's bit for
    bit, and each captured forward launches what the live one launches (int8:
    3 attention, 42 int8_conv, 6 + 10 glu_requant, 26 requant), so the program
    runs the kernels and not their plain versions. The float32 artifact is
    loaded with TF32 switched on beforehand (it must turn it off). Then one x16
    bfloat16 artifact at B = 8; `python -m tgsr_tpu_torch.cli.export_aot` in a
    process of its own, tracing on the CPU (--f32 --batch 8 --platforms
    cpu,cuda, the .pth files of a YAML), whose program the card runs fed 3
    images (padded to the pin, a batch of 9 refused), within 1 uint8 level of
    the same checkpoints' pipeline on the CPU; the int8 artifact loaded in a
    process that imports the op registrations and no model module, bit for
    bit; `cli.serve --aot` booted on the CLI's artifact (batch clamped to the
    pin) answering fixed POSTs (within 1 level of its direct sr_uint8) and a
    native POST with 400. Prints each path's export seconds and .pt2 size, and
    the B = 1 p50 and the img/s at B = 64 under replay beside the live
    pipeline's. Returns the launches of the artifacts' runs."""
    import pickle
    import subprocess
    import threading
    import urllib.error
    import urllib.request

    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.cli import serve
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.data.codec import decode_png, encode_png, resize_pil_bicubic
    from tgsr_tpu_torch.engine import aot
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.ops import _build

    cfg = face_s8_config()
    vocab = len(FACE_WORDS)
    sds = init_seeded(cfg, vocab, torch.Generator().manual_seed(0))
    zero = {name: 0 for name in _build.LAUNCH_NAMES}
    # the CLI's export traces on the CPU in a process of its own while this
    # one exports on the card
    for name, sd in (("netG_epoch_7.pth", sds[1]), ("netGH_epoch_7.pth", sds[2])):
        torch.save(sd, os.path.join(tmp, name))
    words = dict(enumerate(FACE_WORDS))
    vocab_pkl = os.path.join(tmp, "testset.pickle")
    with open(vocab_pkl, "wb") as f:
        pickle.dump([[], words, {w: i for i, w in words.items()}], f)
    yml = os.path.join(tmp, "eval_faceSR.yml")
    with open(yml, "w") as f:
        f.write(FACE_S8_YAML.format(absent_net_e=os.path.join(tmp, "absent_text_encoder.pth")))
    cli_out = os.path.join(tmp, "aot_cli")
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "tgsr_tpu_torch.cli.export_aot", "--cfg", yml, "--netg",
         os.path.join(tmp, "netG_epoch_7.pth"), "--vocab_pickle", vocab_pkl, "--out", cli_out,
         "--f32", "--batch", "8", "--device", "cpu", "--platforms", "cpu,cuda"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def batch(n):
        lr = rng.integers(0, 256, (n, 32, 32, 3)).astype("float32") / 127.5 - 1.0
        lens = rng.integers(1, T + 1, n)
        lens[min(1, n - 1)] = 0  # an empty caption
        cap = rng.integers(1, vocab, (n, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        return lr, cap, lens

    lr, cap, lens = batch(64)
    launches, pairs = {}, {}
    loader = None
    for tag in ("float32", "bfloat16", "int8"):
        per_forward = dict(zero, **PATH_KERNELS[tag])
        kw = dict(compute_dtype=torch.float32 if tag == "float32" else torch.bfloat16)
        if tag == "int8":
            kw["quant_scales"] = scales
        live = SRPipeline(cfg, vocab, *sds, **kw)
        t0 = time.perf_counter()
        path = aot.export_serving(live, os.path.join(tmp, f"aot_{tag}"))
        t_export = time.perf_counter() - t0
        mb = os.path.getsize(os.path.join(path, aot.FORWARD_FILE)) / 2 ** 20
        if tag == "float32":
            # a float32 artifact pins float32 math, as a float32 SRPipeline does
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        t0 = time.perf_counter()
        art = aot.AOTPipeline(path)
        t_load = time.perf_counter() - t0
        check(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
              and art.pins_float32_math == (tag == "float32"),
              f"aot {tag}: TF32 off after the load (switched on before it: "
              f"{tag == 'float32'}), pinned by the artifact: {art.pins_float32_math}")
        check(art.meta["batch"] == "symbolic" and art.meta["quantized"] == (tag == "int8")
              and art.meta["compute_dtype"] == ("float32" if tag == "float32" else "bfloat16"),
              f"aot {tag}: meta.json {art.meta}")
        _build.reset_launches()
        got = {b: art.sr_uint8(lr[:b], cap[:b], lens[:b]) for b in (1, 3, 64)}
        torch.cuda.synchronize()
        run = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in zero}
        replayed = dict(_build.REPLAYED)
        ref = {b: live.sr_uint8(lr[:b], cap[:b], lens[:b]) for b in (1, 3, 64)}
        launches[f"aot {tag}"] = run
        check(replayed == {k: 3 * v for k, v in per_forward.items()}
              and sorted(g_b for g_b, _ in art.graphs) == [1, 4, 64]
              and all(g.launches == per_forward for g in art.graphs.values())
              and all(g.launches == per_forward for g in live.graphs.values()),
              f"aot {tag}: each captured forward of the artifact launches what the live "
              f"pipeline's launches ({per_forward}); replayed {replayed}")
        same = {b: bool(np.array_equal(got[b], ref[b])) for b in got}
        check(all(same.values()), f"aot {tag}: the artifact's SR equals the live pipeline's "
                                  f"bit for bit at B = 1, 3, 64 ({same})")
        print(f"  aot {tag}: export {t_export:.2f} s, forward.pt2 {mb:.2f} MiB, load "
              f"{t_load:.2f} s; B = 1, 3, 64 bit for bit the live pipeline {same}", flush=True)
        if tag == "int8":
            # a process of its own loads it while this one goes on
            np.savez(os.path.join(tmp, "aot_in.npz"), lr=lr[:3], cap=cap[:3], lens=lens[:3])
            loader = subprocess.Popen(
                [sys.executable, "-c", AOT_LOADER, path, os.path.join(tmp, "aot_in.npz"),
                 os.path.join(tmp, "aot_out.npy")],
                cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            int8_ref3 = ref[3]
        pairs[tag] = (live, art)
    # the x16 family: one bfloat16 artifact at B = 8
    cfg16, sds16, _, (lr16, cap16, lens16), _ = x16_inputs(torch)
    lr16 = lr16.astype("float32") / 127.5 - 1.0
    live16 = SRPipeline(cfg16, 41, *sds16, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    art16 = aot.AOTPipeline(aot.export_serving(live16, os.path.join(tmp, "aot_x16")))
    t16 = time.perf_counter() - t0
    _build.reset_launches()
    got16 = art16.sr_uint8(lr16, cap16, lens16)
    torch.cuda.synchronize()
    launches["aot x16 bfloat16"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in zero}
    replayed = dict(_build.REPLAYED)
    want16 = dict(zero, word_pixel_attention=4, up_head_packed=2)
    ref16 = live16.sr_uint8(lr16, cap16, lens16)
    check(got16.shape == (8, 512, 512, 3) and np.array_equal(got16, ref16)
          and replayed == want16
          and all(g.launches == want16 for g in [*art16.graphs.values(), *live16.graphs.values()]),
          f"aot x16 bfloat16: B = 8 bit for bit the live pipeline, 4 attention + 2 packed "
          f"up-head launches a forward ({replayed})")
    print(f"  aot x16 bfloat16: export and load {t16:.2f} s, B = 8 bit for bit the live "
          f"pipeline: {np.array_equal(got16, ref16)}", flush=True)
    del live16, art16
    # the CLI's artifact: traced on the CPU, batch pinned at 8, run on the card
    log, _ = cli.communicate(timeout=600)
    t_cli = time.perf_counter() - t_cli
    check(cli.returncode == 0 and "exported" in log,
          f"aot cli: python -m tgsr_tpu_torch.cli.export_aot --device cpu exits "
          f"{cli.returncode} ({log.strip().splitlines()[-1:] if log.strip() else ''})")
    art_cli = aot.AOTPipeline(cli_out)
    plain = SRPipeline.from_reference_checkpoints(cfg, vocab, os.path.join(tmp, "netG_epoch_7.pth"),
                                                  device="cpu")
    live_cli = SRPipeline.from_reference_checkpoints(cfg, vocab,
                                                     os.path.join(tmp, "netG_epoch_7.pth"))
    _build.reset_launches()
    got = art_cli.sr_uint8(lr[:3], cap[:3], lens[:3])
    torch.cuda.synchronize()
    launches["aot cli float32"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in zero}
    replayed = dict(_build.REPLAYED)
    cpu = plain.sr_uint8(lr[:3], cap[:3], lens[:3])
    sel = np.arange(8) % 3
    card_ref = live_cli.sr_uint8(lr[sel], cap[sel], lens[sel])[:3]
    worst = int(np.abs(got.astype(int) - cpu.astype(int)).max())
    try:
        art_cli.sr_uint8(lr[:9], cap[:9], lens[:9])
        refused = False
    except ValueError:
        refused = True
    check(art_cli.meta["batch"] == 8 and art_cli.meta["platforms"] == ["cpu", "cuda"]
          and list(art_cli.graphs) == [(8, T)] and worst <= 1 and refused
          and replayed == dict(zero, **PATH_KERNELS["float32"]),
          f"aot cli: the CPU-traced float32 program (batch 8) on the card fed 3 images is "
          f"within 1 uint8 level of the pipeline on the CPU (max {worst}), launches the "
          f"float32 kernels ({replayed}), and refuses 9")
    print(f"  aot cli: export on the CPU in its own process {t_cli:.2f} s (beside the card "
          f"exports); fed 3 at pin 8: max {worst} level(s) from the CPU pipeline, bit for bit "
          f"the live card pipeline at 8: {np.array_equal(got, card_ref)}", flush=True)
    del plain, live_cli
    # the loader process
    log, _ = loader.communicate(timeout=600)
    mods = next((ln.split()[1:] for ln in log.splitlines()
                 if ln.startswith("AOT_LOADER_MODULES")), None)
    out = (np.load(os.path.join(tmp, "aot_out.npy"))
           if os.path.exists(os.path.join(tmp, "aot_out.npy")) else None)
    check(loader.returncode == 0 and mods is not None and "tgsr_tpu_torch.ops.library" in mods
          and not any(m == "tgsr_tpu" or m.startswith(("tgsr_tpu.", "tgsr_tpu_torch.models",
                                                        "tgsr_tpu_torch.engine.inference"))
                      for m in mods)
          and out is not None and np.array_equal(out, int8_ref3),
          f"aot loader: a process that imports the op registrations and no model module "
          f"serves the int8 artifact bit for bit (exit {loader.returncode}, modules {mods}, "
          f"{log.strip().splitlines()[-1:] if loader.returncode else ''})")
    # cli.serve --aot on the CLI's artifact
    pipe, vocab_s, args = serve.boot(["--aot", cli_out, "--vocab_pickle", vocab_pkl,
                                      "--max_batch", "16"])
    httpd = serve.make_server(pipe, vocab_s, port=0, max_batch=args.max_batch)
    httpd.batcher.warmup()
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    imgs = [rng.integers(0, 256, (40, 40, 3)).astype("uint8") for _ in range(6)]
    caps = face_captions(rng, 6)
    answers = {}

    def post(i, query=""):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/sr{query}",
                                     data=encode_png(imgs[i], filter_rows=True),
                                     headers={"X-Caption": caps[i]}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[i, query] = (r.status, r.read())
        except urllib.error.HTTPError as e:
            answers[i, query] = (e.code, e.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    post(0, "?mode=native")
    httpd.shutdown()
    httpd.server_close()
    httpd.batcher.close()
    server.join(60)
    worst, ok = 0, True
    for i in range(6):
        status, body = answers.get((i, ""), (None, b""))
        ok &= status == 200
        if status == 200:
            c, n = serve.encode_caption_text(caps[i], vocab_s, T)
            x = resize_pil_bicubic(imgs[i], (32, 32)).astype("float32") / 127.5 - 1.0
            direct = pipe.sr_uint8(x[None], c[None], np.asarray([n]))[0]
            worst = max(worst, int(np.abs(direct.astype(int) - decode_png(body).astype(int)).max()))
    status, body = answers.get((0, "?mode=native"), (None, b"{}"))
    check(ok and worst <= 1 and args.max_batch == 8 and status == 400
          and "native mode unavailable" in json.loads(body).get("error", ""),
          f"aot serve: cli.serve --aot (max_batch clamped to {args.max_batch}) answers 6 "
          f"fixed POSTs within 1 level of the direct sr_uint8 (max {worst}) and a native POST "
          f"with {status}")
    print(f"  aot serve: 6 fixed POSTs, max {worst} level(s) from the direct call; native "
          f"answered {status}", flush=True)
    del pipe, art_cli
    # replay times: the artifact beside the live pipeline, in turns
    for tag, (live, art) in pairs.items():
        ms = {"live": [], "aot": []}
        for i in range(40):
            for name, p in (("live", live), ("aot", art)) if i % 2 else (("aot", art),
                                                                        ("live", live)):
                t0 = time.perf_counter()
                p.sr_uint8(lr[:1], cap[:1], lens[:1])
                ms[name].append((time.perf_counter() - t0) * 1e3)
        ips = {"live": [], "aot": []}
        for i in range(6):
            for name, p in (("live", live), ("aot", art)) if i % 2 else (("aot", art),
                                                                        ("live", live)):
                t0 = time.perf_counter()
                p.sr_uint8(lr, cap, lens)
                ips[name].append(64 / (time.perf_counter() - t0))
        print(f"  aot {tag} under replay: B = 1 artifact {percentiles(ms['aot'][5:])}, live "
              f"{percentiles(ms['live'][5:])}; B = 64 artifact "
              f"{np.median(ips['aot']):.1f} img/s, live {np.median(ips['live']):.1f} img/s "
              f"(host clock, uint8 to the host) on {card}", flush=True)
    del pairs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def http_client(port: int, jobs) -> list:
    """One client process's POSTs to the server at `port`, one after
    another: jobs of (index, PNG body, caption, query); returns (index,
    status, response body, round trip ms by the host clock)."""
    import urllib.request

    out = []
    for i, body, caption, query in jobs:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/sr{query}", data=body,
                                     headers={"X-Caption": caption}, method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            status, data = r.status, r.read()
        out.append((i, status, data, (time.perf_counter() - t) * 1e3))
    return out


def png_filters(body: bytes) -> np.ndarray:
    """The row filter types of an 8-bit RGB PNG's image data."""
    import struct
    import zlib

    pos, idat, w = 8, b"", 0
    while pos < len(body):
        length, kind = struct.unpack(">I4s", body[pos:pos + 8])
        if kind == b"IHDR":
            w = struct.unpack(">I", body[pos + 8:pos + 12])[0]
        elif kind == b"IDAT":
            idat += body[pos + 8:pos + 8 + length]
        pos += 12 + length
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(-1, 3 * w + 1)[:, 0]


def codec_share(bodies, shape, sr, p50_ms, tag) -> None:
    """The host's PNG work of one fixed-size request, each step timed alone
    on this host: decoding a request body (its row filters chosen as PNG
    encoders choose them, undone by the C helper) and resizing it to the LR
    size, and encoding the SR (raw rows, as the server writes it); beside
    the round trip's p50, and a 256 px photo-like upload's decode, by the C
    helper and by the Python version, which must agree."""
    from tgsr_tpu_torch.data import codec

    check(codec.unfilter_library() is not None,
          f"http {tag}: the PNG decoder's C helper built on this host")
    hist = np.bincount(np.concatenate([png_filters(b) for b in bodies]), minlength=5)
    t0 = time.perf_counter()
    imgs = [codec.decode_png(b) for b in bodies]
    t1 = time.perf_counter()
    for img in imgs:
        codec.resize_pil_bicubic(img, (32, 32))
    t2 = time.perf_counter()
    for _ in range(8):
        codec.encode_png(sr)
    t3 = time.perf_counter()
    yy, xx = np.mgrid[:256, :256]
    photo = np.clip(np.stack([yy, xx, (yy + xx) // 2], -1)
                    + np.random.default_rng(0).normal(0, 6, (256, 256, 3)), 0, 255)
    big = codec.encode_png(photo.astype("uint8"), filter_rows=True)
    t4 = time.perf_counter()
    got = codec.decode_png(big)
    t5 = time.perf_counter()
    library, codec.unfilter_library = codec.unfilter_library, lambda: None
    try:
        want = codec.decode_png(big)
    finally:
        codec.unfilter_library = library
    t6 = time.perf_counter()
    check(np.array_equal(got, want) and np.array_equal(got, photo.astype("uint8")),
          f"http {tag}: the C helper decodes a 256 px filtered PNG as the Python version does")
    dec, rsz = (t1 - t0) * 1e3 / len(bodies), (t2 - t1) * 1e3 / len(bodies)
    enc = (t3 - t2) * 1e3 / 8
    print(f"  http {tag} codec (host clock): decode of a {shape[0]} x {shape[1]} request body "
          f"{dec:.4f} ms (row filters None/Sub/Up/Average/Paeth {hist.tolist()}), resize "
          f"{rsz:.4f} ms, encode of the {sr.shape[0]} px SR {enc:.4f} ms: "
          f"{(dec + rsz + enc) / p50_ms:.4f} of the round trip's p50 {p50_ms:.4f} ms; a 256 px "
          f"photo-like upload (filters {np.bincount(png_filters(big), minlength=5).tolist()}) "
          f"decodes in {(t5 - t4) * 1e3:.4f} ms, {(t6 - t5) * 1e3:.4f} ms in Python",
          flush=True)


def serve_and_post(torch, rng, card, clients, argv, n_clients, per_thread, n_native, tag,
                   levels=1):
    """Boots the serving CLI (`serve.boot(argv)`), warms it up and sends
    n_clients processes x per_thread fixed-size POSTs (40 x 40 PNGs, rows
    filtered as encoders filter them) with n_native native POSTs (40 x 56)
    in the middle. Each fixed response (served in a batch) within `levels`
    uint8 levels of the direct sr_uint8 (B = 1) on the codec-resized LR, each native one bit for bit the direct
    sr_arbitrary (bucket 64) on the body cropped down to a multiple of the
    scale, as the server crops it; /healthz counts the requests; the replayed
    launches are the captured counts times the replays. Returns (pipeline,
    vocab, the run's launches)."""
    import threading
    import urllib.request

    from tgsr_tpu_torch.cli import serve
    from tgsr_tpu_torch.data.codec import decode_png, encode_png, resize_pil_bicubic
    from tgsr_tpu_torch.ops import _build

    zero = {name: 0 for name in _build.LAUNCH_NAMES}
    pipe, vocab, args = serve.boot(argv)
    httpd = serve.make_server(pipe, vocab, port=0, max_batch=args.max_batch,
                              max_delay_ms=args.max_delay_ms)
    t0 = time.perf_counter()
    httpd.batcher.warmup()
    print(f"  http {tag}: boot and warm-up (graphs at {httpd.batcher.planned_sizes}) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    n = n_clients * per_thread
    fixed = [rng.integers(0, 256, (40, 40, 3)).astype("uint8") for _ in range(n)]
    native = [rng.integers(0, 256, (40, 56, 3)).astype("uint8") for _ in range(n_native)]
    caps = face_captions(rng, n + n_native)
    bodies = [encode_png(x, filter_rows=True) for x in fixed + native]  # as clients send
    jobs = []  # per client: its fixed requests, a native one in the middle
    for k in range(n_clients):
        mine = [(i, bodies[i], caps[i], "") for i in range(k, n, n_clients)]
        if k < n_native:
            mine.insert(per_thread // 2, (n + k, bodies[n + k], caps[n + k], "?mode=native"))
        jobs.append((port, mine))
    out, ms, errors = {}, {}, []
    graphs = {key: g.replays for key, g in pipe.graphs.items()}
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        for res in clients.starmap(http_client, jobs):
            for i, status, body, t in res:
                out[i], ms[i] = (body if status == 200 else None), t
    except Exception as e:  # reported by the check below
        errors.append(repr(e))
    dt = time.perf_counter() - t0
    out = {i: None if body is None else decode_png(body) for i, body in out.items()}
    eager, replayed = dict(_build.LAUNCHES), dict(_build.REPLAYED)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    httpd.shutdown()
    httpd.server_close()
    httpd.batcher.close()
    server.join(60)
    check(not errors and sum(o is not None for o in out.values()) == n + n_native
          and not server.is_alive(),
          f"http {tag}: {len(out)} of {n + n_native} requests answered 200 ({errors})")
    check(health["requests"] == n and sum(health["batch_hist"].values()) == health["batches"],
          f"http {tag}: /healthz counts the {n} batched requests ({health})")
    want_replayed = dict(zero)
    for key, g in pipe.graphs.items():
        for name, v in g.launches.items():
            want_replayed[name] += v * (g.replays - graphs.get(key, 0))
    per_forward = next(iter(pipe.graphs.values())).launches
    check(replayed == want_replayed and eager == {k: v * n_native
                                                 for k, v in per_forward.items()},
          f"http {tag}: replayed launches = captured counts x replays ({replayed}), "
          f"eager = the {n_native} native forwards ({eager})")
    worst, native_same = 0, True
    for i in range(n + n_native):
        cap, length = serve.encode_caption_text(caps[i], vocab, T)
        if i < n:
            lr = resize_pil_bicubic(fixed[i], (32, 32)).astype("float32") / 127.5 - 1.0
            direct = pipe.sr_uint8(lr[None], cap[None], np.asarray([length]))[0]
            worst = max(worst, int(np.abs(direct.astype(int) - out[i].astype(int)).max()))
        else:
            # the server crops a native body down to a multiple of the scale
            img, s = native[i - n], pipe.cfg.scale
            lr = img[:img.shape[0] // s * s, :img.shape[1] // s * s].astype("float32")
            lr = lr / 127.5 - 1.0
            direct = pipe.sr_arbitrary(lr[None], cap[None], np.asarray([length]),
                                       bucket=64)[0]
            native_same &= np.array_equal(direct, out[i])
    check(worst <= levels, f"http {tag}: every fixed-size response within {levels} uint8 "
                           f"level(s) of the direct sr_uint8 (B = 1) on the codec-resized LR "
                           f"(max {worst})")
    check(native_same, f"http {tag}: every native response bit for bit the direct "
                       f"sr_arbitrary (bucket 64)")
    lat = np.asarray([ms[i] for i in range(n)])
    lat_native = [ms[i] for i in range(n, n + n_native)]
    print(f"  http {tag}, {n_clients} client processes x {per_thread} fixed + {n_native} "
          f"native POSTs: {dt:.3f} s, {(n + n_native) / dt:.2f} img/s, round trip of the "
          f"fixed ones {percentiles(lat)}, native {percentiles(lat_native)}, batch histogram "
          f"{health['batch_hist']} (host clock, seeded weights) on {card}", flush=True)
    codec_share(bodies[:n], fixed[0].shape, out[0], np.percentile(lat, 50), tag)
    return pipe, vocab, {k: eager[k] + replayed[k] for k in eager}


def http_phase(torch, rng, card, tmp, clients):
    """The serving CLI on the card: boot a bf16 server through the --cfg /
    --netg / --vocab_pickle path (seeded .pth files, a 41-word vocab
    pickle and a face S8 eval YAML in `tmp`, read by the port's YAML
    reader, its NET_E a file that is absent, so that resolve_net_e falls
    through to the shipped NET_E, which the check finds served); 8 client
    processes x 16 fixed-size POSTs of 40 x 40 PNGs (rows filtered as PNG
    encoders filter them), 4 of them with a native POST of 40 x 56 in the
    middle. Each fixed response within 1 uint8 level of the direct
    sr_uint8 on the codec-resized LR, each native one bit for bit the direct
    sr_arbitrary; /healthz counts the requests; the replayed launches are
    the captured counts times the replays. Then an int8 bundle (scales from
    calibrate_quant) served through --artifact, each fixed response within
    INT8_BATCH_LEVELS of the direct sr_uint8. `clients`: a pool of 8
    processes that send the requests, as a server's clients are processes
    of their own. Returns the launches of both runs."""
    import pickle

    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.checkpoints.reference import load_text_encoder
    from tgsr_tpu_torch.checkpoints.shipped import shipped_net_e
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline

    cfg = face_s8_config()
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    for name, sd in (("netG_epoch_7.pth", sds[1]), ("netGH_epoch_7.pth", sds[2])):
        torch.save(sd, os.path.join(tmp, name))
    words = dict(enumerate(FACE_WORDS))
    with open(os.path.join(tmp, "testset.pickle"), "wb") as f:
        pickle.dump([[], words, {w: i for i, w in words.items()}], f)
    with open(os.path.join(tmp, "eval_faceSR.yml"), "w") as f:
        f.write(FACE_S8_YAML.format(absent_net_e=os.path.join(tmp, "absent_text_encoder.pth")))


    argv = ["--cfg", os.path.join(tmp, "eval_faceSR.yml"), "--netg",
            os.path.join(tmp, "netG_epoch_7.pth"), "--vocab_pickle",
            os.path.join(tmp, "testset.pickle")]
    pipe, vocab, bf16_counts = serve_and_post(torch, rng, card, clients, argv, 8, 16, 4, "bf16")
    shipped = load_text_encoder(shipped_net_e(41))
    check(shipped.keys() == pipe.state_dicts[0].keys()
          and all(torch.equal(v, pipe.state_dicts[0][k]) for k, v in shipped.items()),
          "http bf16: the YAML's NET_E is absent, and the server's text encoder is the shipped "
          "trained NET_E")
    check(pipe.compute_dtype == torch.bfloat16 and not pipe.quant_scales
          and bf16_counts["word_pixel_attention"] > 0 and bf16_counts["up_head_packed"] > 0,
          f"http bf16: the --cfg path serves the bf16 pipeline through rows 1 and 3")
    lr = rng.integers(0, 256, (16, 32, 32, 3)).astype("float32") / 127.5 - 1.0
    cap = rng.integers(1, 41, (16, T))
    scales = pipe.calibrate_quant(lr, cap, np.full(16, T))
    int8 = SRPipeline(cfg, 41, *pipe.state_dicts, a=pipe.a, device="cuda",
                      compute_dtype=torch.bfloat16, quant_scales=scales)
    bundle = os.path.join(tmp, "int8_bundle")
    int8.save_artifact(bundle, vocab=vocab)
    del pipe, int8
    gc.collect()
    torch.cuda.empty_cache()
    pipe8, _, int8_counts = serve_and_post(torch, rng, card, clients,
                                           ["--artifact", bundle, "--max_batch", "8"], 4, 4, 1,
                                           "int8", levels=INT8_BATCH_LEVELS)
    int8_rows = ("word_pixel_attention", "int8_conv", "glu_requant_one", "glu_requant_pair",
                 "requant")
    check(bool(pipe8.quant_scales) and all(int8_counts[k] > 0 for k in int8_rows),
          f"http int8: the --artifact bundle serves int8 through rows 1, 8, 9, X1 and X2 "
          f"({int8_counts})")
    del pipe8
    gc.collect()
    torch.cuda.empty_cache()
    return bf16_counts, int8_counts


def eval_phase(torch, rng, card):
    """evaluate_sr on 64 seeded 256 px HR images (smooth ramps with noise),
    on the card in float32 and bfloat16 and on the CPU in float32, every
    kernel site there plain: float32 PSNR-Y within 0.01 dB and SSIM-Y within
    1e-4 of the CPU's, bfloat16 within EVAL_BF16_*; the first batch's SR
    images on the card within 40 dB (uint8 PSNR) of the CPU's. Returns the
    card runs' launches."""
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.evaluator import evaluate_sr
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.ops import _build
    from tgsr_tpu_torch.ops.image import normalize_uint8, resize

    cfg = face_s8_config()
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(0))
    batches = []
    yy, xx = np.mgrid[:256, :256]
    for _ in range(4):
        tilt = rng.uniform(0.3, 3.0, (16, 1, 1, 3))
        base = yy[None, ..., None] + xx[None, ..., None] * tilt
        hr = base * 255.0 / base.max(axis=(1, 2, 3), keepdims=True)
        hr = np.clip(hr + rng.normal(0, 10, hr.shape), 0, 255).astype("uint8")
        lens = rng.integers(1, T + 1, 16)
        cap = rng.integers(1, 41, (16, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        batches.append({"hr": hr, "captions": cap, "cap_lens": lens})
    res, counts, sr0 = {}, {}, {}
    for tag, device, dtype in (("cpu float32", "cpu", torch.float32),
                               ("float32", "cuda", torch.float32),
                               ("bfloat16", "cuda", torch.bfloat16)):
        pipe = SRPipeline(cfg, 41, *sds, device=device, compute_dtype=dtype)
        _build.reset_launches()
        res[tag] = evaluate_sr(pipe, batches)
        if device == "cuda":
            torch.cuda.synchronize()
            counts[tag] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in _build.LAUNCHES}
        with torch.inference_mode():  # the first batch's SR, to hold against the CPU's
            hr = torch.as_tensor(batches[0]["hr"], device=device)
            lr = resize(normalize_uint8(hr), (32, 32), "bilinear")
            sr0[tag] = pipe(lr, batches[0]["captions"], batches[0]["cap_lens"])["sr"].cpu()
        r = res[tag]
        check(r["images"] == 64 and np.isfinite(r["psnr_y"]) and -1 <= r["ssim_y"] <= 1,
              f"eval {tag}: 64 images, PSNR-Y {r['psnr_y']:.4f} dB, SSIM-Y {r['ssim_y']:.6f}")
        print(f"  eval {tag}: PSNR-Y {r['psnr_y']!r} dB, SSIM-Y {r['ssim_y']!r}, "
              f"{r['images_per_sec_host_e2e']:.2f} img/s host end to end (seeded weights)"
              f"{'' if device == 'cpu' else ' on ' + card}", flush=True)
        del pipe
    ref = res["cpu float32"]
    for tag, dp, ds in (("float32", 0.01, 1e-4),
                        ("bfloat16", EVAL_BF16_PSNR_GAP_DB, EVAL_BF16_SSIM_GAP)):
        gp, gs = abs(res[tag]["psnr_y"] - ref["psnr_y"]), abs(res[tag]["ssim_y"] - ref["ssim_y"])
        check(gp <= dp and gs <= ds, f"eval {tag} on the card vs float32 on the CPU: PSNR-Y gap "
                                     f"{gp:.6f} dB <= {dp}, SSIM-Y gap {gs:.3e} <= {ds}")
    for tag in ("float32", "bfloat16"):
        psnr = psnr_u8(sr0[tag], sr0["cpu float32"])
        check(psnr >= 40, f"eval {tag} on the card vs float32 on the CPU, the first batch's 16 "
                          f"SR images: uint8 PSNR {psnr:.2f} dB >= 40")
    check(counts["float32"]["up_head"] > 0 and counts["bfloat16"]["up_head_packed"] > 0,
          "eval: the card runs went through the up-head kernels")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# CelebA's 40 attributes (list_attr_celeba.txt's header): the face example
# set's vocabulary, 41 words with <end>, so that resolve_net_e picks the
# shipped trained NET_E
CELEBA_ATTRS = ("5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs "
                "Big_Lips Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair Bushy_Eyebrows Chubby "
                "Double_Chin Eyeglasses Goatee Gray_Hair Heavy_Makeup High_Cheekbones Male "
                "Mouth_Slightly_Open Mustache Narrow_Eyes No_Beard Oval_Face Pale_Skin "
                "Pointy_Nose Receding_Hairline Rosy_Cheeks Sideburns Smiling Straight_Hair "
                "Wavy_Hair Wearing_Earrings Wearing_Hat Wearing_Lipstick Wearing_Necklace "
                "Wearing_Necktie Young").split()
CLI_IMAGES = 4  # the example set's images, one batch of every run


def face_example_set(rng, root, n_images):
    """The reference's face eval layout in `root`: testset.txt in CelebA's
    attribute format (the first n_images rows, 1-2 attributes each, caption
    the images in Img/changetxt_im1/; 40 more rows name every attribute
    once, Blurry on the test rows, so that the vocabulary is the 41 words)
    and n_images seeded PNGs of 300 x 280 (ramps and noise)."""
    from tgsr_tpu_torch.data.codec import encode_png

    img_dir = os.path.join(root, "Img", "changetxt_im1")
    os.makedirs(img_dir)
    blurry = CELEBA_ATTRS.index("Blurry")
    others = [k for k in range(40) if k != blurry]
    rows = []
    for i in range(n_images):
        r = np.zeros(40, int)
        r[rng.choice(others, rng.integers(1, 3), replace=False)] = 1
        rows.append(r)
    for k in others + [blurry]:  # Blurry's row last: a test row
        r = np.zeros(40, int)
        r[k] = 1
        rows.append(r)
    with open(os.path.join(root, "testset.txt"), "w") as f:
        f.write(" ".join(CELEBA_ATTRS) + " \n")
        for i, r in enumerate(rows):
            f.write(f"{i:06d}.jpg " + " ".join(map(str, r)) + "\n")
    yy, xx = np.mgrid[:300, :280]
    for i in range(n_images):
        img = np.stack([(yy * rng.uniform(0.3, 1.5) + xx * rng.uniform(0.3, 1.5)) % 256
                        for _ in range(3)], -1)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype("uint8")
        with open(os.path.join(img_dir, f"{i:06d}.png"), "wb") as f:
            f.write(encode_png(img))


def cli_phase(torch, rng, card, tmp):
    """The eval and calibration entry points (tgsr_tpu_torch.cli.test and
    .calibrate) on the card at face S8 full width: a face example set in the
    reference's layout (CLI_IMAGES PNGs of 300 x 280, CelebA attribute
    captions, the 41-word vocabulary), a YAML, seeded .pth files and the
    shipped NET_E through resolve_net_e. Runs, each with the launch counts
    set to 0 before and read after: the bfloat16 default with --metrics
    (every SR and grid written and decoding, each SR within 1 level of
    sr_uint8 on the same LR, captions and weights, the metrics within the
    eval gates against float32 on the CPU); --no-bf16 (SR within 1 level of
    float32 on the CPU, and the card's attention maps within 1e-4 of the
    CPU's), --int8 --save_artifact (the bundle serves within 1 level of the
    CLI's SR), --no-bf16 --int8 (the float32 instances; PSNR against
    float32 on the CPU at least the CPU's own int8-float32 figure less 1
    dB, on the first two images), --arbitrary --bucket 64 (bit for bit
    sr_arbitrary), cli.calibrate --batches 2 (scales within 1e-4 relative
    of a CPU calibration of the same views; the gate passes), cli.test
    --scales --arbitrary on its file, and --gate_db 99 (writes nothing).
    Prints each run's images per second and host seconds per grid (host
    clock). Returns the launches of each run."""
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.checkpoints.shipped import shipped_net_e
    from tgsr_tpu_torch.cli import calibrate as cal_cli
    from tgsr_tpu_torch.cli import test as test_cli
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.data.codec import decode_png
    from tgsr_tpu_torch.data.datasets import load_arbitrary_eval_image
    from tgsr_tpu_torch.data.pipeline import BatchLoader
    from tgsr_tpu_torch.engine.evaluator import evaluate_sr
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.engine.quant import merge_scales
    from tgsr_tpu_torch.ops import _build

    data = os.path.join(tmp, "face")
    face_example_set(rng, data, CLI_IMAGES)
    cfg = face_s8_config()
    sds = init_seeded(cfg, 41, torch.Generator().manual_seed(1))
    ckpt = os.path.join(tmp, "face_ckpt")
    os.makedirs(ckpt)
    for name, sd in (("netG_epoch_7.pth", sds[1]), ("netGH_epoch_7.pth", sds[2])):
        torch.save(sd, os.path.join(ckpt, name))
    yml = os.path.join(tmp, "eval_faceSR_cli.yml")
    with open(yml, "w") as f:
        f.write(FACE_S8_YAML.format(absent_net_e=os.path.join(tmp, "absent_text_encoder.pth")))
    netg = os.path.join(ckpt, "netG_epoch_7.pth")
    net_e = shipped_net_e(41)
    base = ["--cfg", yml, "--ckpt_dir", ckpt, "--batch", str(CLI_IMAGES), "--data_dir", data]
    launches = {}

    def run(tag, main, argv):
        """One CLI run with the counts set to 0 before it and read after."""
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        summary = main(base + argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[f"cli {tag}"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k]
                                  for k in _build.LAUNCHES}
        ran = {k: v for k, v in launches[f"cli {tag}"].items() if v}
        if "images" in summary:
            grid = (f", {summary['grid_seconds'] / summary['grids']:.4f} s per grid "
                    f"({summary['grids']} grids)" if summary.get("grids") else "")
            print(f"  cli {tag}: {summary['images']} images in {dt:.3f} s, "
                  f"{summary['images'] / dt:.2f} img/s (host clock, whole run){grid}; "
                  f"launches {ran} on {card}", flush=True)
        else:
            print(f"  cli {tag}: {dt:.3f} s (host clock); launches {ran} on {card}", flush=True)
        return summary

    def outputs(summary, n, grids=True):
        """(keys, SR uint8 images, grid shapes) read back through the PNG
        decoder, every file present."""
        out = summary["out_dir"]
        keys = [f"{i:06d}" for i in range(n)]
        srs, shapes, ok = [], [], True
        for key in keys:
            path = os.path.join(out, f"{key}_SR.png")
            ok &= os.path.exists(path)
            if ok:
                with open(path, "rb") as f:
                    srs.append(decode_png(f.read()))
            if grids:
                path = os.path.join(out, "att", f"{key}.png")
                ok &= os.path.exists(path)
                if ok:
                    with open(path, "rb") as f:
                        shapes.append(decode_png(f.read()).shape)
        return ok, srs, shapes

    def loader():
        """The CLI's own loader of the set (one batch)."""
        ds = test_cli.build_example_dataset(test_cli.load_config(yml, data))
        return BatchLoader(ds, CLI_IMAGES, shuffle=False, drop_last=False,
                           deterministic_captions=True)

    def worst_level(srs, refs):
        return max(int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(srs, refs))

    # -- the bfloat16 default with --metrics ---------------------------------------
    s = run("bf16", test_cli.main, ["--out_dir", os.path.join(tmp, "o_bf16"), "--metrics"])
    ok, srs, shapes = outputs(s, CLI_IMAGES)
    check(ok and s["images"] == s["grids"] == CLI_IMAGES and all(
        x.shape == (256, 256, 3) for x in srs) and all(
        h == 306 and w % 258 == 0 and c == 3 for h, w, c in shapes),
        f"cli bf16: {CLI_IMAGES} <key>_SR.png and att/<key>.png written and decoding "
        f"(grids {sorted(set(shapes))})")
    ref = SRPipeline.from_reference_checkpoints(cfg, 41, netg, text_encoder_path=net_e,
                                                compute_dtype=torch.bfloat16)
    batch = next(iter(loader().epoch(0)))
    lr_s = test_cli.degrade(batch["hr"], 32, "cuda")
    lr_cpu, cap_s, lens_s = lr_s.cpu().numpy(), batch["captions"], batch["cap_lens"]
    worst = worst_level(srs, ref.sr_uint8(lr_cpu, cap_s, lens_s))
    check(worst <= 1, f"cli bf16: every SR within 1 uint8 level of sr_uint8 on the same LR, "
                      f"captions and weights (max {worst})")
    plain = SRPipeline.from_reference_checkpoints(cfg, 41, netg, text_encoder_path=net_e,
                                                  device="cpu")
    m_cpu = evaluate_sr(plain, loader().epoch(0))
    m = s["metrics"]
    gp, gs = abs(m["psnr_y"] - m_cpu["psnr_y"]), abs(m["ssim_y"] - m_cpu["ssim_y"])
    check(m["images"] == CLI_IMAGES and gp <= EVAL_BF16_PSNR_GAP_DB and gs <= EVAL_BF16_SSIM_GAP,
          f"cli bf16 --metrics vs float32 on the CPU: PSNR-Y {m['psnr_y']!r} dB (gap {gp:.6f} "
          f"<= {EVAL_BF16_PSNR_GAP_DB}), SSIM-Y {m['ssim_y']!r} (gap {gs:.3e} <= "
          f"{EVAL_BF16_SSIM_GAP})")
    counts = launches["cli bf16"]
    check(counts["word_pixel_attention"] > 0 and counts["up_head_packed"] > 0,
          "cli bf16: the forward with attention maps went through rows 1 and 3")
    del ref

    # -- float32: the SR and the attention maps against the CPU ------------------
    s = run("float32", test_cli.main, ["--out_dir", os.path.join(tmp, "o_f32"), "--no-bf16"])
    ok, srs, _ = outputs(s, CLI_IMAGES)
    ref_f32 = plain(lr_cpu, cap_s, lens_s)
    sr_cpu = to_uint8(ref_f32["sr"]).numpy()
    worst = worst_level(srs, sr_cpu) if ok else 255
    check(ok and worst <= 1, f"cli float32: every SR within 1 uint8 level of float32 on the "
                             f"CPU (max {worst})")
    card_f32 = SRPipeline.from_reference_checkpoints(cfg, 41, netg, text_encoder_path=net_e,
                                                     return_attn=True)
    att = card_f32(lr_s, cap_s, lens_s)["attn"]
    plain.return_attn = True
    att_cpu = plain(lr_cpu, cap_s, lens_s)["attn"]
    plain.return_attn = False
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(att, att_cpu))
    check(err <= 1e-4, f"cli float32: the card's attention maps (3 stages) within 1e-4 of the "
                       f"CPU's (max abs err {err:.3e})")
    check(launches["cli float32"]["up_head"] > 0, "cli float32: went through row 2")
    del card_f32

    # -- int8 (bfloat16 compute) and its bundle ----------------------------------
    bundle = os.path.join(tmp, "cli_int8_bundle")
    s = run("int8", test_cli.main, ["--out_dir", os.path.join(tmp, "o_i8"), "--int8",
                                    "--save_artifact", bundle])
    ok, srs, _ = outputs(s, CLI_IMAGES)
    pipe, vocab = SRPipeline.load_artifact(bundle, device="cuda")
    served = pipe.sr_uint8(lr_cpu, cap_s, lens_s)
    worst = worst_level(srs, served) if ok else 255
    check(ok and bool(pipe.quant_scales) and vocab.n_words == 41 and not pipe.return_attn
          and worst <= 1, f"cli int8 --save_artifact: the bundle serves int8 within 1 uint8 "
                          f"level of the CLI's SR (max {worst})")
    counts = launches["cli int8"]
    check(all(counts[k] > 0 for k in ("int8_conv", "glu_requant_one", "glu_requant_pair",
                                      "requant")),
          "cli int8: went through rows 8, 9, X1 and X2 (bfloat16 instances)")
    del pipe

    # -- int8 with float32 compute (the float32 instances) -----------------------
    bundle32 = os.path.join(tmp, "cli_int8_f32_bundle")
    s = run("float32 int8", test_cli.main, ["--out_dir", os.path.join(tmp, "o_i8f32"),
                                            "--no-bf16", "--int8", "--save_artifact", bundle32])
    ok, srs, _ = outputs(s, CLI_IMAGES)
    with open(os.path.join(bundle32, "quant_scales.json")) as f:
        scales32 = json.load(f)
    cpu_i8 = SRPipeline.from_reference_checkpoints(cfg, 41, netg, text_encoder_path=net_e,
                                                   device="cpu", quant_scales=scales32)
    floor = psnr_u8(cpu_i8(lr_cpu[:2], cap_s[:2], lens_s[:2])["sr"], ref_f32["sr"][:2])
    got = torch.from_numpy(np.stack(srs[:2])).float() / 127.5 - 1.0 if ok else None
    psnr = psnr_u8(got, ref_f32["sr"][:2]) if ok else 0.0
    print(f"  int8 with float32 compute vs float32, both on the CPU (2 images): "
          f"uint8 PSNR {floor:.2f} dB", flush=True)
    check(ok and psnr >= floor - 1.0, f"cli float32 int8: SR on the card vs float32 on the CPU "
                                      f"PSNR {psnr:.2f} dB >= {floor - 1.0:.2f} (the CPU's own "
                                      f"int8-float32 figure less 1 dB)")
    counts = launches["cli float32 int8"]
    f32_rows = ("int8_conv_f32", "glu_requant_one_f32", "glu_requant_pair_f32", "requant_f32")
    check(all(counts[k] > 0 for k in f32_rows) and not any(
        counts[k] for k in ("int8_conv", "glu_requant_one", "glu_requant_pair", "requant")),
        f"cli float32 int8: went through the float32 instances of rows 8, 9, X1 and X2 and none "
        f"of the bfloat16 ones ({ {k: counts[k] for k in f32_rows} })")
    del cpu_i8

    # -- native geometry ---------------------------------------------------------
    s = run("arbitrary", test_cli.main, ["--out_dir", os.path.join(tmp, "o_arb"), "--arbitrary",
                                         "--bucket", "64"])
    ok, srs, _ = outputs(s, CLI_IMAGES, grids=False)
    ref = SRPipeline.from_reference_checkpoints(cfg, 41, netg, text_encoder_path=net_e,
                                                compute_dtype=torch.bfloat16)
    same = ok
    for i in range(CLI_IMAGES if ok else 0):
        lr, _ = load_arbitrary_eval_image(os.path.join(data, "Img", "changetxt_im1",
                                                       f"{i:06d}.png"), 8)
        sr = ref.sr_arbitrary(lr, cap_s[i:i + 1], lens_s[i:i + 1], bucket=64)[0]
        same &= srs[i].shape == (296, 280, 3) and np.array_equal(sr, srs[i])
    check(same and s["lr_shapes"] == 1, f"cli --arbitrary --bucket 64: {CLI_IMAGES} SR of "
                                        f"296 x 280, bit for bit sr_arbitrary ({s['lr_shapes']} "
                                        f"LR shape run)")
    del ref

    # -- calibration, --scales, the gate -----------------------------------------
    out = os.path.join(tmp, "cli_scales.json")
    s = run("calibrate", cal_cli.main, ["--out", out, "--batches", "2"])
    per_view = [plain.calibrate_quant(lr, cap, lens) for lr, cap, lens in s["views"]]
    cpu = {g: merge_scales(*(v[g] for v in per_view)) for g in per_view[0]}
    rel = max(abs(s["scales"][g][k] - cpu[g][k]) / cpu[g][k] for g in cpu for k in cpu[g])
    check(os.path.exists(out) and s["scales"].keys() == cpu.keys() and all(
        s["scales"][g].keys() == cpu[g].keys() for g in cpu) and rel <= 1e-4,
        f"cli calibrate: {sum(len(v) for v in cpu.values())} scales within 1e-4 relative of a "
        f"CPU calibration of the same {len(s['views'])} views (max {rel:.2e}); gate "
        f"{s['psnr']:.2f} dB passed")
    s = run("scales", test_cli.main, ["--out_dir", os.path.join(tmp, "o_scales"), "--scales",
                                      out, "--arbitrary"])
    check(s["images"] == CLI_IMAGES and launches["cli scales"]["int8_conv"] > 0,
          "cli --scales --arbitrary: the calibrated file serves int8 without calibrating")
    never = os.path.join(tmp, "never.json")
    try:
        cal_cli.main(base + ["--out", never, "--batches", "1", "--gate_db", "99"])
        refused = False
    except SystemExit as e:
        refused = "fidelity gate failed" in str(e)
    check(refused and not os.path.exists(never), "cli calibrate --gate_db 99: refused, nothing "
                                                 "written")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the three training sites of the attention (px), at the trainer's batch
TRAIN_B = 16
X16_TRAIN_B = 16  # configs/train_faceSR_S16.yml's TRAIN.BATCH_SIZE
TRAIN_SITES = (32, 64, 128)
# step_against_cpu: a card step's gradient tensors' L2 errors against the
# float64 CPU step, in units of twice the CPU float32 step's + 1e-5 |g|: the
# median tensor of each card step at most GRAD_MEDIAN, every tensor at most
# GRAD_OUTLIER_FACTOR: two to three times the largest card readings on 12
# seeded batches (`--step-readings 1-12`: medians up to 0.905 with cuDNN
# off, 1.86 on; one tensor up to 349)
GRAD_MEDIAN = {"cuDNN off": 2.0, "cuDNN on": 4.0}
GRAD_OUTLIER_FACTOR = 1000
# the same median gate for G's step with SimpleCNN's DAMSM terms (D frozen).
# The terms' gradient back through a trained SimpleCNN is ill-conditioned in
# float32: the ReLUs a run's rounding flips decide whether its image
# gradient lands 1e-5 or 7e-3 off float64, so card and CPU part by that
# luck. Readings (`--step-readings 1-8 --damsm`, a one-epoch SimpleCNN):
# medians up to 0.86 cuDNN off, 1.33 on; the phase's own batch 2.44 off
# (the card's image gradient 5.65e-3 off float64, the CPU's 1.71e-3), 0.73
# on. About 2.5 times the largest. The terms weighted 1.1 read at most
# 1.38: this gate holds G's backward, DAMSM_ELEMENT_RATIO the terms'
GRAD_MEDIAN_DAMSM = {"cuDNN off": 6.0, "cuDNN on": 4.0}
# SimpleCNN's backward alone on the card (`damsm_input_grads` (b)): the
# median element's error against float64 at most this many times the
# CPU's. `--step-readings 1-8 --damsm`: 0.65-1.63 (ReLU flips included);
# the card's gradient 1e-3 off reads 470-1,430
DAMSM_ELEMENT_RATIO = 4.0
# `--step-readings --damsm`'s controls: the card's DAMSM terms weighted
# 1 + these, read in the gate's units (what a fault of that size reads)
CONTROL_DELTAS = (1e-3, 1e-2, 1e-1)
TRAIN_MS: dict = {}  # train_phase's ms a step at B = 16, by path, for damsm_phase
# the face S8 training config (configs/train_faceSR_S8.yml at full width) for
# the CLI run: BATCH_SIZE cut to 2 so that the example set's 4 train images
# make 2 steps an epoch, a snapshot every 2 steps
FACE_S8_TRAIN_YAML = """# face S8 training: x8, 32 px -> 256 px (configs/train_faceSR_S8.yml)
CONFIG_NAME: 'face_S8_train'
METHOD: 'S8'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: 32
DATASET_NAME: 'face'
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 2
    SNAPSHOT_INTERVAL: 2
GAN:
    DF_DIM: 64
    GF_DIM: 32
    R_NUM: 2
TEXT:
    EMBEDDING_DIM: 256
    CAPTIONS_PER_IMAGE: 1
"""


def attention_grads(torch, fn, px, wd, mask, g, ga):
    """(dpixels, dwords) of sum(ctx * g) + sum(attn * ga) through `fn`, and a
    closure that runs that backward again on the graph kept."""
    px = px.detach().requires_grad_()
    wd = wd.detach().requires_grad_()
    ctx, attn = fn(px, wd, mask, return_attn=ga is not None)
    loss = (ctx * g).sum() + ((attn * ga).sum() if ga is not None else 0)
    again = lambda: torch.autograd.grad(loss, (px, wd), retain_graph=True)
    return again(), again


def attention_bwd_phase(torch, rng, hws=TRAIN_SITES, b=TRAIN_B, ga_hw=64, what="x8"):
    """Row "1 bwd": the attention's backward kernel against autograd of its
    plain version on the card at the training sites (B = 16, C 32, T 18,
    ragged captions with one padded everywhere, a gradient on the attention
    map at `ga_hw` px, none where it is None), float32 and bfloat16. float32: max abs error <= 1e-5
    max(1, |ref|max); bfloat16 (against float32 on the same inputs):
    |err| - 2^-8 |ref| <= 1e-5 max(1, |ref|max). Two calls give the same
    bits. Times the backward alone (the kernel's two launches) against the
    plain backward on a kept graph, and SDPA forward + backward on the same
    shapes, for scale, not the same function."""
    import torch.nn.functional as F

    from tgsr_tpu_torch.ops import _build
    from tgsr_tpu_torch.ops.attention import word_pixel_attention as plain
    from tgsr_tpu_torch.ops.fused_attention import word_pixel_attention, word_pixel_attention_bwd

    bwd = [(n, u) for n, u in ptxas_entries(_build.build_log("word_pixel_attention"))
           if "word_pixel_attention_bwd_kernel" in n]
    spills = sum(u["spill_store_bytes"] + u["spill_load_bytes"] for _, u in bwd)
    check(len(bwd) == 8 and spills == 0,
          f"attention backward kernel ptxas: {len(bwd)} instances (float32 and bfloat16, TB 8 "
          f"to 32), registers {sorted(u['registers'] for _, u in bwd)}, {spills} bytes spilled")

    lens = rng.integers(1, T + 1, b)
    lens[1] = 0
    mask = torch.as_tensor(np.arange(T)[None, :] >= lens[:, None], device="cuda")
    out = {}
    for dtype, esize, rate in ((torch.float32, 4, F32_FLOP_PER_S),
                               (torch.bfloat16, 2, BF16_FLOP_PER_S)):
        tag = str(dtype).split(".")[-1]
        rows = []
        for hw in hws:
            px, g = (torch.randn(b, hw, hw, C, device="cuda").to(dtype) for _ in range(2))
            wd = torch.randn(b, T, C, device="cuda").to(dtype)
            ga = torch.randn(b, T, hw, hw, device="cuda").to(dtype) if hw == ga_hw else None
            ref, plain_again = attention_grads(torch, plain, px.float(), wd.float(), mask,
                                               g.float(), ga.float() if ga is not None else None)
            got, _ = attention_grads(torch, word_pixel_attention, px, wd, mask, g, ga)
            twice, _ = attention_grads(torch, word_pixel_attention, px, wd, mask, g, ga)
            torch.cuda.synchronize()
            err, excess, same = 0.0, 0.0, True
            for k, r, t2 in zip(got, ref, twice):
                scale = 1e-5 * max(1.0, r.abs().max().item())
                e = (k.float() - r).abs()
                err = max(err, e.max().item())
                rel = e if dtype == torch.float32 else e - 2 ** -8 * r.abs()
                excess = max(excess, rel.max().item() / scale)
                same &= torch.equal(k, t2)
            check(excess <= 1.0 and same,
                  f"attention backward kernel {tag} == plain autograd at [{b},{hw},{hw},{C}] T "
                  f"{T}{' with an attention-map gradient' if ga is not None else ''} (max abs "
                  f"err {err:.3e}, {excess:.3f} of the gate), the same bits twice")
            run = lambda: word_pixel_attention_bwd(px, wd, mask, g, ga)
            ms = cuda_ms(run, iters=20, warmup=3)
            d_ms = device_ms(torch, run, iters=10)
            if dtype == torch.float32:
                _, p_again = attention_grads(torch, plain, px, wd, mask, g, ga)
            else:
                p_again = plain_again
            p_ms = cuda_ms(p_again)
            q = px.reshape(b, hw * hw, C).detach().requires_grad_()
            kv = wd.detach().requires_grad_()
            keep = ~mask[:, None, :]

            def sdpa():
                o = F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep, scale=1.0)
                torch.autograd.grad(o, (q, kv), g.reshape(b, hw * hw, C))

            l_ms = cuda_ms(sdpa)
            n = b * hw * hw
            # pixels and g in, dpixels out; words in, dwords out; the mask;
            # the attention map's gradient where given
            nbytes = (esize * (3 * n * C + 2 * b * T * C) + b * T
                      + (esize * n * T if ga is not None else 0))
            flops = n * (10 * T * C + 8 * T)  # logits, dA, dP, dW (two), softmax and dS
            bms, by = bound_ms(nbytes, flops, rate)
            print(f"  attention backward {tag} {hw}x{hw}: kernel {ms:.4f} ms (device time "
                  f"{d_ms:.4f}), plain autograd {p_ms:.4f} ms, sdpa fwd+bwd {l_ms:.4f} ms (for "
                  f"scale, not the same function), bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it "
                  f"reached)", flush=True)
            rows.append(dict(ms=ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bms,
                             nbytes=nbytes, flops=flops, err=err))
        tot = sums(rows, keys=("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "nbytes",
                               "flops"))
        tot["bound_by"] = bound_ms(tot.pop("nbytes"), tot.pop("flops"), rate)[1]
        out[tag] = tot
    return {"name": "word_pixel_attention_bwd", "route": "cuda",
            "source": "tgsr_tpu_torch/csrc/word_pixel_attention.cu",
            "replaces": "tgsr_tpu/ops/pallas_attention.py:30", **out["float32"],
            "bfloat16": out["bfloat16"],
            "shapes": f"B {b}, C {C}, T {T}, HW {'+'.join(f'{hw}^2' for hw in hws)} (one {what} "
                      f"training step's {len(hws)} sites"
                      + (f", an attention-map gradient at {ga_hw}^2" if ga_hw in hws else "")
                      + "); the backward alone (the tiles and their sum); no Pallas backward "
                      "exists (JAX differentiates XLA's einsum path); library_ms: SDPA forward + "
                      "backward, for scale, not the same function"}


def train_batch(torch, rng, b, device="cuda", vocab=41, empty=True, sizes=(64, 128, 256)):
    """A face S8 training batch of noise images (train-mode BN of a constant
    image divides by sqrt(eps) at every layer), ragged captions with one
    padded everywhere (`empty`; the DAMSM runs leave it out: the words loss
    of an empty caption is the -1e9 sentinel's, about 1e9 gamma3 / B, in
    both packages); NHWC in [-1, 1]; `sizes` the pyramid (x16: to 512 px)."""
    lens = rng.integers(1, T + 1, b)
    if empty:
        lens[min(1, b - 1)] = 0
    caps = rng.integers(1, vocab, (b, T))
    caps[np.arange(T)[None, :] >= lens[:, None]] = 0
    u = lambda s: torch.from_numpy(rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)).to(device)
    return {"lr": u(32), "real_pyramid": [u(s) for s in sizes],
            "captions": torch.from_numpy(caps).to(device),
            "cap_lens": torch.from_numpy(lens).to(device)}


def trainer_readout(torch, state):
    """{name: (param, grad from Adam's first moment, sqrt(v_hat))} of every
    parameter and {name: stat} of every BN running stat, on the CPU."""
    params = {}
    for opt, named in ((state.g_opt, state.g_named_parameters()),
                       (state.d_opt, [(f"d.{n}", p) for n, p in state.dnets.named_parameters()])):
        for n, p in named:
            st = opt.state[p]
            bias = 1 - 0.999 ** float(st["step"])
            params[n] = (p.detach().cpu(), (st["exp_avg"] / 0.5).cpu(),
                         (st["exp_avg_sq"] / bias).sqrt().cpu())
    stats = {}
    for prefix, module in (("netg", state.netg), ("netgh", state.netgh), ("d", state.dnets)):
        for n, v in module.state_dict().items():
            if n.endswith("running_mean") or n.endswith("running_var"):
                stats[f"{prefix}.{n}"] = v.cpu()
    return params, stats


def profile_step(torch, fn, tag: str, top: int = 10, b: int = TRAIN_B) -> None:
    """Device time of one training step at batch b, fn(), by kernel
    (torch.profiler, CUPTI), and its idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print("  profile: no device time recorded (not measured)", flush=True)
        return
    dev = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  profile of one {tag} training step at B={b}: device {dev:.3f} ms, wall "
          f"{wall:.3f} ms under the profiler, idle share {max(0.0, 1 - dev / wall):.3f}, "
          f"{sum(e.count for e in events)} kernels", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:9.3f} ms {ms / dev:6.1%} x{e.count:<4d} {e.key[:90]}", flush=True)


def face_train_set(rng, root, n_images):
    """The reference's face training layout in `root`: list_attr_celeba.txt
    (n_images rows, 1-2 attributes each; the last row Blurry, the test split)
    and seeded PNGs of 300 x 280 (ramps and noise) under Img/."""
    from tgsr_tpu_torch.data.codec import encode_png

    os.makedirs(os.path.join(root, "Img"))
    blurry = CELEBA_ATTRS.index("Blurry")
    others = [k for k in range(40) if k != blurry]
    yy, xx = np.mgrid[:300, :280]
    with open(os.path.join(root, "list_attr_celeba.txt"), "w") as f:
        f.write(" ".join(CELEBA_ATTRS) + " \n")
        for i in range(n_images):
            r = np.zeros(40, int)
            r[rng.choice(others, rng.integers(1, 3), replace=False)] = 1
            r[blurry] = int(i == n_images - 1)
            f.write(f"{i:06d}.jpg " + " ".join(map(str, r)) + "\n")
            img = np.stack([(yy * rng.uniform(0.3, 1.5) + xx * rng.uniform(0.3, 1.5)) % 256
                            for _ in range(3)], -1)
            img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype("uint8")
            with open(os.path.join(root, "Img", f"{i:06d}.png"), "wb") as g:
                g.write(encode_png(img))


def _step_readout(torch, cfg, text_sd, batch, image_encoder, d_lr, tag, device, dtype,
                  cudnn=True, remat=False, loss_weights=None):
    """One fresh training step of `cfg`'s model on `batch`: (metrics,
    trainer_readout). Under PyTorch's default TF32 switches on the card (the
    trainer turns TF32 off); a CPU step touches no global switch."""
    import contextlib
    import copy

    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer

    t = GANTrainer(cfg, 41, text_sd, compute_dtype=dtype, device=device, d_lr=d_lr,
                   image_encoder=copy.deepcopy(image_encoder), loss_weights=loss_weights,
                   remat=remat)
    s = t.init_state(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    with (torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=True) if device == "cuda"
          else contextlib.nullcontext()):
        m = t.train_step(s, batch)
    out = ({k: float(v) for k, v in m.items()}, *trainer_readout(torch, s))
    print(f"  train step {str(dtype).split('.')[-1]} B={len(batch['lr'])} (D lr {t.d_lr}) on "
          f"{device}{', ' + tag if device == 'cuda' else ''}: "
          f"{time.perf_counter() - t0:.2f} s (host clock, first step)", flush=True)
    return out


def cpu_reference_steps(torch, cfg, text_sd, batch, image_encoder=None, d_lrs=(None, 0.0)):
    """`step_against_cpu`'s CPU steps, float32 and float64, for each D
    learning rate: {d_lr: {"cpu": readout, "f64": readout}}. They touch no
    global switch, so they may run in a thread beside card work (x16_train_phase
    runs them beside its plans)."""
    return {d_lr: {tag: _step_readout(torch, cfg, text_sd, batch, image_encoder, d_lr, tag,
                                      "cpu", dtype)
                   for tag, dtype in (("cpu", torch.float32), ("f64", torch.float64))}
            for d_lr in d_lrs}


def step_against_cpu(torch, cfg, text_sd, batch, image_encoder=None,
                     d_lrs=(None, 0.0), control=None, remats=(False,), cpu_runs=None) -> dict:
    """One float32 training step of `cfg`'s model (the face S8 one, or x16)
    on `batch` (B = 4 or 2, on the CPU) on the card twice, cuDNN off and on
    (as training runs it), and on the CPU, each held against the same step in
    float64 on the CPU; once with D learning and once with D's learning rate
    0; the card steps once per policy of `remats` (the CPU's steps without
    remat: there remat changes no bit, tests/test_torch_remat.py). Returns
    {(D lr, card step): {gradient tensor: its ratio}, (statistic, D lr, card
    step): their median, 90th percentile and largest relative L2 error} (the
    ratios in units of the tight gate).

    A GAN step's gradients cancel (BN biases, the attention's projection,
    the heads' weight gradients, sums over every pixel), so two float32
    programs part there by their rounding alone, and Adam's first step
    (+-lr an entry, whatever its size) follows the sign of entries that
    rounding decides. D's first update moves such entries, and G's gradient
    read through that D parts by percents: D is held with D learning, G and
    every BN stat with D's learning rate 0, where all three read one D.

    Gates, each card step: metrics within rtol 1e-4 of the CPU's (with D
    learning, those that do not read the updated D: d_loss, kl, pixel);
    gradients
    (Adam's first moment) against the float64 step's, in units of the tight
    gate (twice the CPU float32 step's L2 error + 1e-5 |g|): the median
    tensor within GRAD_MEDIAN of it (cuDNN's algorithms part from float64
    more than PyTorch's own convolutions), and every tensor within
    GRAD_OUTLIER_FACTOR of it (sums over every pixel, BN biases and weight
    gradients, part from float64 up to hundreds of times more on the card
    than on the CPU as far as the batch makes them cancel, with cuDNN and
    without; with cuDNN, on some batches, every tensor of one DNet);
    parameters within 1e-6 of the
    float64 step's off the entries at Adam's epsilon in any of the three
    steps and those whose float32 gradient has the other sign (the card at
    most twice the CPU's count + 0.1 %); BN running stats within twice the
    CPU's max error + 1e-6. `image_encoder`: the DAMSM terms on (a copy of
    it in each trainer); `d_lrs`: the D learning rates to run (None: D
    learning, 0.0: D frozen); `control`: {label: loss_weights}, each for one
    more card step (cuDNN off) with those weights, whose median ratio is
    read (key ("median", D lr, label)) and not gated: what a fault of that
    size reads. `cpu_runs`: the CPU steps made already by
    `cpu_reference_steps` on the same inputs."""
    card_tags = [f"cuDNN {on}" + ("" if r is False else f", remat {r}")
                 for r in remats for on in ("off", "on")]

    def one_step(d_lr):
        if cpu_runs is None:
            out = cpu_reference_steps(torch, cfg, text_sd, batch, image_encoder, (d_lr,))[d_lr]
        else:
            out = dict(cpu_runs[d_lr])
        runs = [(tag, tag.startswith("cuDNN on"), r, None)
                for tag, r in zip(card_tags, [r for r in remats for _ in range(2)])]
        runs += [(label, False, False, weights) for label, weights in (control or {}).items()]
        for tag, cudnn, remat, weights in runs:
            out[tag] = _step_readout(torch, cfg, text_sd, batch, image_encoder, d_lr, tag,
                                     "cuda", torch.float32, cudnn, remat, weights)
        return out

    def worst3(ratios):
        top = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
        return max(ratios.values()), ", ".join(f"{n} {r:.3g}" for n, r in top)

    readings = {}
    terms = "" if image_encoder is None else f", DAMSM terms ({type(image_encoder).__name__})"
    medians = GRAD_MEDIAN if image_encoder is None else GRAD_MEDIAN_DAMSM
    for d_lr, net, what in ((None, "d.", "D learning: D's step"),
                            (0.0, "net", "D frozen: G's step")):
        if d_lr not in d_lrs:
            continue
        out = one_step(d_lr)
        (m_c, p_c, s_c), (_, p_64, s_64) = out["cpu"], out["f64"]
        mine = [n for n in p_64 if n.startswith(net)]

        def grad_ratios(p_g):
            # each tensor's card error in units of the gate, and the card's
            # and the CPU's relative L2 errors
            ratios, rel = {}, {}
            for n in mine:
                ref = p_64[n][1]
                e_card, e_cpu = ((x[n][1] - ref).norm().item() for x in (p_g, p_c))
                ratios[n] = e_card / (2 * e_cpu + 1e-5 * ref.norm().item())
                rel[n] = np.array([e_card, e_cpu]) / max(ref.norm().item(), 1e-30)
            return ratios, rel

        for label in control or {}:
            ratios, _ = grad_ratios(out[label][1])
            med = float(np.median(list(ratios.values())))
            readings["median", d_lr, label] = med
            print(f"  control, {what}{terms}: the card step (cuDNN off) with {label}: median "
                  f"{med:.3g} units (not gated)", flush=True)
        for card_tag in card_tags:
            m_g, p_g, s_g = out[card_tag]
            gate = medians[card_tag.split(",")[0]]
            head = f"train f32 step card ({card_tag}) vs CPU, {what}{terms}"
            keys = ("d_loss", "kl", "pixel") if d_lr is None else sorted(m_c)
            worst, key = max((abs(m_g[k] - m_c[k]) / abs(m_c[k]), k) for k in keys)
            check(worst <= 1e-4, f"{head}: metrics {', '.join(keys)} within rtol 1e-4 (worst "
                                 f"{key} {worst:.2e})")
            ratios, rel = grad_ratios(p_g)
            readings[d_lr, card_tag] = ratios
            top, names = worst3(ratios)
            p10, med, p90 = (float(np.percentile(list(ratios.values()), q))
                             for q in (10, 50, 90))
            far = max(rel, key=lambda n: rel[n][0])
            readings["p10", d_lr, card_tag] = p10
            readings["median", d_lr, card_tag] = med
            readings["p90", d_lr, card_tag] = p90
            readings["relative L2", d_lr, card_tag] = rel[far][0]
            check(med <= gate and top <= GRAD_OUTLIER_FACTOR,
                  f"{head}: {len(mine)} gradient tensors against the float64 step's, in units "
                  f"of twice the CPU float32 step's L2 error + 1e-5 |g|: median {med:.3g} (<= "
                  f"{gate}), worst {names} (<= {GRAD_OUTLIER_FACTOR}); 10th and "
                  f"90th percentiles {p10:.3g}, {p90:.3g}; relative L2 error at most "
                  f"{rel[far][0]:.3g} ({far}, the CPU's {rel[far][1]:.3g})")
            # Adam's first step is lr g / (|g| + eps) an entry: +-lr, the sign
            # of its gradient, where |g| is well above eps in all three steps;
            # an entry whose float32 gradient has the other sign than the
            # float64 one moves the other way, so those are left out, and the
            # card may have no more of them than the CPU
            ratios, flips = {}, {"card": 0, "cpu": 0, "all": 0, "eps": 0}
            for n in mine:
                p64, g64, root64 = p_64[n]
                eps = ((g64.abs() < 1e-6 * g64.abs().max()) | (root64 < 1e-5)
                       | (p_g[n][2] < 1e-5) | (p_c[n][2] < 1e-5))
                flip = {k: (torch.sign(x[n][1]) != torch.sign(g64)) & ~eps
                        for k, x in (("card", p_g), ("cpu", p_c))}
                for k in ("card", "cpu"):
                    flips[k] += int(flip[k].sum())
                flips["all"] += g64.numel()
                flips["eps"] += int(eps.sum())
                ratios[n] = torch.where(eps | flip["card"], 0.0,
                                        (p_g[n][0] - p64).abs()).max().item() / 1e-6
            top, names = worst3(ratios)
            check(top <= 1.0 and flips["card"] <= 2 * flips["cpu"] + 1e-3 * flips["all"],
                  f"{head}: parameters within 1e-6 of the float64 step's, off the "
                  f"{flips['eps']} of {flips['all']} entries at Adam's epsilon and those whose "
                  f"float32 gradient has the other sign (card {flips['card']}, CPU "
                  f"{flips['cpu']}; worst, in units of the gate: {names})")
            ratios = {}
            for n, ref in s_64.items():
                if d_lr is None and n.startswith("d."):
                    continue  # D's G-step calls read the updated D
                e_card = (s_g[n] - ref).abs().max().item()
                e_cpu = (s_c[n] - ref).abs().max().item()
                ratios[n] = e_card / (2 * e_cpu + 1e-6 * (1 + ref.abs().max().item()))
            top, names = worst3(ratios)
            check(top <= 1.0, f"{head}: BN running stats as near the float64 step's as the "
                              f"CPU's (max error <= 2x the CPU's + 1e-6; worst, in units of the "
                              f"gate: {names})")
    return readings


def train_cpu_inputs(torch):
    """train_phase's face S8 config and seeded text encoder."""
    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.config import face_s8_config

    cfg = face_s8_config()
    return cfg, seeded_text_state_dict(cfg, 41, torch.Generator().manual_seed(14))


def train_phase(torch, rng, card, tmp, cpu_batch, cpu_runs):
    """GAN training of the face S8 model at full width on the card (seeded
    weights, noise images). (1) One float32 step at B = 4 (`cpu_batch`) on
    the card, with cuDNN off and on, against the CPU's, both held against
    the same step in float64 on the CPU (`step_against_cpu`, TF32 off; the
    CPU steps `cpu_runs` made beside x16_train_phase's plans, from
    `train_cpu_inputs`). (2) Ten steps
    at B = 16 in float32 and in bfloat16: finite metrics, bf16's first-step
    metrics within 15 % of f32's, 3 attention forward and 3 backward
    launches a step, the step's ms (host clock, synchronised), img/s, peak
    reserved memory, and one profiled step.
    (3) The CLI (`tgsr_tpu_torch.cli.train_gan.main`, what `python -m
    tgsr_tpu_torch.cli.train_gan` runs) on a face set in the training layout
    for 2 epochs of 2 steps, snapshots every 2 steps and --eval_every 2; its
    last snapshot pair served by SRPipeline on the card against the run's EMA
    generator eagerly on the same input. Returns the launches of each run."""
    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.cli import train_gan
    from tgsr_tpu_torch.data.datasets import TextFaceDataset
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.ops import _build

    cfg, text_sd = train_cpu_inputs(torch)
    launches = {}

    # -- (1) one float32 step, card against CPU ------------------------------------
    step_against_cpu(torch, cfg, text_sd, cpu_batch, cpu_runs=cpu_runs)

    # -- (2) ten steps at B = 16, float32 and bfloat16 ---------------------------------
    batches = [train_batch(torch, rng, TRAIN_B) for _ in range(10)]
    first = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "train " + str(dtype).split(".")[-1]
        t = GANTrainer(cfg, 41, text_sd, compute_dtype=dtype)
        s = t.init_state(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        times, metrics = [], []
        for b in batches:
            t0 = time.perf_counter()
            metrics.append(t.train_step(s, b))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches[tag] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in _build.LAUNCHES}
        peak = torch.cuda.max_memory_reserved() / 2 ** 30
        vals = [{k: float(v) for k, v in m.items()} for m in metrics]  # one host sync
        first[dtype] = vals[0]
        check(all(np.isfinite(v) for m in vals for v in m.values()),
              f"{tag}: 10 steps at B = {TRAIN_B}, every metric finite")
        per = {k: launches[tag][k] / 10
               for k in ("word_pixel_attention", "word_pixel_attention_bwd")}
        check(per == {"word_pixel_attention": 3, "word_pixel_attention_bwd": 3},
              f"{tag}: 3 attention forward and 3 backward launches a step ({per})")
        ms = 1e3 * float(np.mean(times[1:]))
        TRAIN_MS[tag] = ms
        print(f"  {tag}: step {ms:.2f} ms (host clock, synchronised, mean of steps 2-10; "
              f"first {1e3 * times[0]:.1f}), {TRAIN_B * 1e3 / ms:.1f} img/s, peak reserved "
              f"{peak:.2f} GiB, on {card}; d_loss {vals[0]['d_loss']:.4f} -> "
              f"{vals[-1]['d_loss']:.4f}, pixel {vals[0]['pixel']:.4f} -> {vals[-1]['pixel']:.4f}",
              flush=True)
        profile_step(torch, lambda: t.train_step(s, batches[0]), tag)
        del t, s
        gc.collect()
        torch.cuda.empty_cache()
    worst = max(abs(first[torch.bfloat16][k] - v) / abs(v)
                for k, v in first[torch.float32].items() if abs(v) > 1e-3)
    check(worst < 0.15, f"train bf16 first-step metrics within 15 % of f32's (worst {worst:.3%})")

    # -- (3) the CLI ---------------------------------------------------------------------
    data = os.path.join(tmp, "face_train")
    face_train_set(rng, data, 5)
    yml = os.path.join(tmp, "train_faceSR_S8.yml")
    with open(yml, "w") as f:
        f.write(FACE_S8_TRAIN_YAML)
    n_words = TextFaceDataset(data, split="train", words_num=T, imsize=256).n_words
    te = os.path.join(tmp, "train_text_encoder.pth")
    torch.save(seeded_text_state_dict(cfg, n_words, torch.Generator().manual_seed(15)), te)
    out = os.path.join(tmp, "train_out")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    summary = train_gan.main(["--cfg", yml, "--data_dir", data, "--out_dir", out,
                              "--text_encoder", te, "--eval_every", "2", "--log_every", "1"])
    dt = time.perf_counter() - t0
    launches["train cli"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in _build.LAUNCHES}
    snaps = sorted(os.listdir(os.path.join(out, "Model")))
    with open(os.path.join(out, "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    print(f"  train cli: {summary['steps']} steps in {dt:.2f} s (host clock, whole run, kernels "
          f"built); snapshots {snaps}", flush=True)
    check(summary["steps"] == 4 and snaps == ["netGH_it2.msgpack", "netGH_it4.msgpack",
                                              "netG_it2.msgpack", "netG_it4.msgpack"]
          and sum("val_psnr_y" in r for r in rows) == 2
          and launches["train cli"]["word_pixel_attention_bwd"] == 12,
          "train cli: 4 steps, snapshots at 2 and 4, 2 eval rows, 12 backward launches")
    state, trainer = summary["state"], summary["trainer"]
    pipe = SRPipeline.from_reference_checkpoints(cfg, n_words, os.path.join(out, "Model",
                                                                            "netG_it4.msgpack"),
                                                 text_encoder_path=te)
    b = train_batch(torch, rng, 4, vocab=n_words)
    lr_cpu = b["lr"].cpu().numpy()
    served = pipe(lr_cpu, b["captions"].cpu().numpy(), b["cap_lens"].cpu().numpy())["sr"]
    eager = trainer.super_resolve(state, b)
    err = (served.to(eager.device) - eager).abs().max().item()
    check(err <= 1e-3, f"train cli: its last snapshot pair served by SRPipeline on the card == "
                       f"the run's EMA generator eagerly (max abs err {err:.3e} <= 1e-3)")
    del pipe, summary, state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- training that resumes and spreads over ranks (parallel/, checkpoints/dcp_io) ---

SCALE_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
def scale_run(torch, cfg, text_sd, batch, steps, dtype, coupled=False, **kw):
    """`steps` steps of a fresh seeded GANTrainer (kw: mesh, fsdp,
    image_encoder, loss_weights) on one batch: (metrics of each step as
    floats, the state whole on the CPU), the launches of the steps, and how
    many parameters the state stores sharded. `coupled`: within
    `data_parallel.couple_one_rank` (a group of one rank kept)."""
    import contextlib

    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.ops import _build
    from tgsr_tpu_torch.parallel import data_parallel
    from tgsr_tpu_torch.parallel.multihost import fetch_to_host

    with data_parallel.couple_one_rank() if coupled else contextlib.nullcontext():
        t = GANTrainer(cfg, 41, text_sd, compute_dtype=dtype, **kw)
        s = t.init_state(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        _build.reset_launches()
        ms = [t.train_step(s, batch) for _ in range(steps)]
        torch.cuda.synchronize()
        counts = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in _build.LAUNCHES}
        out = ([{k: float(v) for k, v in m.items()} for m in ms],
               fetch_to_host(s.state_dict()))
        n_sharded = len(s.shards)
    del t, s
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts, n_sharded


def state_diff(torch, a, b) -> list:
    """The metrics and state tensors in which two `scale_run` results differ
    in any bit."""
    (ma, sa), (mb, sb) = a, b
    out = [f"step {i} {k}" for i, (x, y) in enumerate(zip(ma, mb)) for k in x if x[k] != y[k]]
    return out + [k for k in sa if not torch.equal(sa[k], sb[k])]


# how far one float32 step of the data-parallel code may lie from the plain
# step (tests/test_torch_data_parallel.py's float32 gates): metrics rtol,
# Adam's moments relative L2 a tensor, BN running stats relative L2 a
# tensor, and the share of parameter and EMA entries more than 1e-6 apart
# (where Adam's first step turns on a gradient's last bits). G's moments are
# held with D frozen: with D learning, G's gradient runs through the updated
# D, whose first Adam step follows the sign of each gradient entry, so a
# last-bit change in a near-zero entry moves that weight by 2 lr (face S8 at
# B = 16 on the card: G's moments 1.3e-2 apart that way, D's before its
# update within the gate)
COUPLED_GATES = {"metrics": 1e-4, "moments": 1e-3, "stats": 1e-4, "params": 0.01}


def coupled_gaps(torch, ref, got, moments_of=("g_opt.", "d_opt.")) -> dict:
    """The `COUPLED_GATES` readings of `scale_run` result `got` against
    `ref`, the moments those of the optimizers `moments_of`."""
    (mr, sr), (mg, sg) = ref, got

    def rel(a, b):
        a, b = a.double(), b.double()
        n = a.norm()
        return float((a - b).norm() / n) if n > 0 else float((a - b).norm())

    params = [k for k in sr if sr[k].is_floating_point() and "running_" not in k
              and not k.startswith(("g_opt.", "d_opt."))]
    moments = sorted((rel(sr[k], sg[k]), k) for k in sr if k.startswith(moments_of)
                     and k.endswith(("exp_avg", "exp_avg_sq")))
    return {"metrics": max(abs(x[k] - y[k]) / max(abs(x[k]), 1e-30)
                           for x, y in zip(mr, mg) for k in x),
            "moments": moments[-1][0], "worst moment": moments[-1][1],
            "stats": max(rel(sr[k], sg[k]) for k in sr if "running_" in k),
            "params": sum(int(((sr[k] - sg[k]).abs() > 1e-6).sum()) for k in params)
            / sum(sr[k].numel() for k in params)}


def train_scale_phase(torch, rng, card, tmp):
    """Training that resumes and spreads over ranks, on the card, world size
    1 over NCCL (the launcher's variables set here; NCCL refuses two ranks
    on one device, so the two-rank maths is held on the CPU under gloo,
    tests/test_torch_data_parallel.py). Face S8 at full width, B = 16.
    (1) Under torch.use_deterministic_algorithms: the plain step twice, the
    data-parallel step (`mesh`, a 1x1 `parallel.mesh.make_mesh`) and the
    `fsdp` step, two steps each in float32 and one in bfloat16; DP and fsdp
    bit for bit the plain step (metrics and every tensor of the train
    state), rows 1 and 1 bwd launched 3 times a step on both paths. A group
    of one rank is dropped there, so those steps run the single-process
    code. (1b) Within `data_parallel.couple_one_rank` (the group kept), one
    float32 step with SimpleCNN's DAMSM terms: BN's global moments, the DP
    losses and gathers run (counted), the DP and fsdp (sharded as over two
    ranks) steps within `COUPLED_GATES` of the plain step (G's moments with
    D frozen, `d_lr` 0), fsdp bit for bit DP, rows 1 and 1 bwd 3 times
    each. (2) The
    train-state checkpoint (`checkpoints/dcp_io.TrainCheckpointer`): its
    bytes, save() (the blocking device-to-host copy) and the write's
    seconds, a restore's, the restored state bit for bit the saved one, and
    the step's time while a write is in flight against without one (host
    clock, synchronised). (3) `cli.train_gan.main` (what `python -m
    tgsr_tpu_torch.cli.train_gan` runs) with `--mesh 1x1`, under
    deterministic algorithms and within `couple_one_rank`: whole (4 steps),
    and again with `--fsdp` (a sharded checkpoint), stopped by a SIGTERM
    sent to the process during its second step, then rerun with `--resume`:
    the resumed run's last snapshot pair is the whole run's, byte for
    byte. Returns the launches of (1)'s DP and fsdp runs."""
    import signal
    import warnings

    import torch.distributed as dist

    from tgsr_tpu_torch.checkpoints import dcp_io
    from tgsr_tpu_torch.checkpoints.from_jax import (seeded_cnn_encoder_state_dict,
                                                     seeded_text_state_dict)
    from tgsr_tpu_torch.cli import train_gan
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.data.datasets import TextFaceDataset
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.models.image_encoder import make_image_encoder
    from tgsr_tpu_torch.parallel import data_parallel, multihost
    from tgsr_tpu_torch.parallel.mesh import make_mesh

    cfg = face_s8_config()
    text_sd = seeded_text_state_dict(cfg, 41, torch.Generator().manual_seed(14))
    launches = {}
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(multihost.free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        rank = multihost.initialize_distributed("cuda")
        mesh = make_mesh(1, 1, device="cuda")
        check(rank == 0 and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"scale: a process group of 1 rank over {dist.get_backend()}, mesh "
              f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}")

        # -- (1) DP and fsdp against the plain step, bit for bit -------------------------
        batch = train_batch(torch, np.random.default_rng(20), TRAIN_B)
        for dtype, steps in ((torch.float32, 2), (torch.bfloat16, 1)):
            name = str(dtype).split(".")[-1]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    plain = [scale_run(torch, cfg, text_sd, batch, steps, dtype)[0]
                             for _ in range(2)]
                    dp, n_dp, _ = scale_run(torch, cfg, text_sd, batch, steps, dtype, mesh=mesh)
                    fs, n_fs, _ = scale_run(torch, cfg, text_sd, batch, steps, dtype, mesh=mesh,
                                            fsdp=True)
                finally:
                    torch.use_deterministic_algorithms(False)
            ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                          if "deterministic" in str(w.message)})
            launches[f"train dp {name}"], launches[f"train fsdp {name}"] = n_dp, n_fs
            twice = state_diff(torch, plain[0], plain[1])
            print(f"  scale {name}: {steps} steps at B = {TRAIN_B}, deterministic algorithms "
                  f"({len(ops)} ops without one: {ops[:4]}); two plain runs differ in "
                  f"{len(twice)} tensors, DP in {len(state_diff(torch, plain[0], dp))}, fsdp in "
                  f"{len(state_diff(torch, plain[0], fs))}", flush=True)
            check(not twice, f"scale {name}: the plain step repeats bit for bit under "
                             f"deterministic algorithms ({twice[:4]})")
            for tag, run in (("DP (--mesh 1x1)", dp), ("fsdp (--mesh 1x1 --fsdp)", fs)):
                diff = state_diff(torch, plain[0], run)
                check(not diff, f"scale {name}: the {tag} step == the plain step, bit for bit "
                                f"(metrics, parameters, BN stats, EMA, both Adams; world size "
                                f"1 drops the group of one rank, so this step is the "
                                f"single-process code plus a 1-rank all-reduce of gradients "
                                f"and metrics, and (1b) drives the coupled code; "
                                f"{len(diff)} differ: {diff[:4]})")
            for tag, n in (("DP", n_dp), ("fsdp", n_fs)):
                per = {k: n[k] / steps for k in ("word_pixel_attention",
                                                 "word_pixel_attention_bwd")}
                check(per == {"word_pixel_attention": 3, "word_pixel_attention_bwd": 3},
                      f"scale {name} {tag}: rows 1 and 1 bwd launched 3 times a step ({per})")

        # -- (1b) the data-parallel code itself, over the group of one rank ---------------
        # (1)'s DP and fsdp steps drop a group of one rank and run the single-process
        # code; within couple_one_rank the group is kept: BN's global moments, the DP
        # discriminator loss, the DAMSM terms' gathers and the fsdp storage (sharded as
        # over two ranks, each chunk whole) run their NCCL collectives on the card
        enc = make_image_encoder(True, 256)
        enc.load_state_dict(seeded_cnn_encoder_state_dict(True, 256,
                                                          torch.Generator().manual_seed(21)))
        crng = np.random.default_rng(21)
        cb = {**train_batch(torch, crng, TRAIN_B, empty=False),
              "class_ids": torch.from_numpy(crng.integers(0, TRAIN_B // 2, TRAIN_B)).cuda()}
        ckw = dict(image_encoder=enc, loss_weights={"damsm": 0.5})
        calls = {"all_reduce_sum": 0, "gather_rows": 0}
        real = {k: getattr(data_parallel, k) for k in calls}

        def counted(name):
            def run(*args, **kw):
                calls[name] += 1
                return real[name](*args, **kw)
            return run

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            cplain = scale_run(torch, cfg, text_sd, cb, 1, torch.float32, **ckw)[0]
            frozen = scale_run(torch, cfg, text_sd, cb, 1, torch.float32, d_lr=0.0, **ckw)[0]
            for k in calls:
                setattr(data_parallel, k, counted(k))
            try:
                cdp, n_cdp, _ = scale_run(torch, cfg, text_sd, cb, 1, torch.float32, mesh=mesh,
                                          coupled=True, **ckw)
                dp_calls = dict(calls)
                cfs, n_cfs, n_sharded = scale_run(torch, cfg, text_sd, cb, 1, torch.float32,
                                                  mesh=mesh, fsdp=True, coupled=True, **ckw)
                frozen_dp = scale_run(torch, cfg, text_sd, cb, 1, torch.float32, mesh=mesh,
                                      coupled=True, d_lr=0.0, **ckw)[0]
            finally:
                for k, f in real.items():
                    setattr(data_parallel, k, f)
        finally:
            torch.use_deterministic_algorithms(False)
        launches["train dp coupled float32"] = n_cdp
        launches["train fsdp coupled float32"] = n_cfs
        gaps = {tag: coupled_gaps(torch, cplain, run, moments_of=("d_opt.",))
                for tag, run in (("DP", cdp), ("fsdp", cfs))}
        gaps["DP, D frozen"] = coupled_gaps(torch, frozen, frozen_dp)
        between = state_diff(torch, cdp, cfs)
        print(f"  scale coupled float32 (one step at B = {TRAIN_B}, SimpleCNN's DAMSM terms, "
              f"the group of one rank kept): collectives a DP step {dp_calls}; against the "
              f"plain step (D's moments; G's too with D frozen) {gaps}; fsdp ({n_sharded} "
              f"parameters sharded) against DP {len(between)} tensors differ", flush=True)
        check(dp_calls["all_reduce_sum"] > 0 and dp_calls["gather_rows"] > 0,
              f"scale coupled: the DP step over the group of one rank runs BN's global moments "
              f"and the cross-rank gathers ({dp_calls})")
        for tag, g in gaps.items():
            check(all(g[k] <= COUPLED_GATES[k] for k in COUPLED_GATES),
                  f"scale coupled: the {tag} step over the group of one rank within "
                  f"{COUPLED_GATES} of the plain step ({g})")
        check(n_sharded > 0 and not between,
              f"scale coupled: fsdp stores {n_sharded} parameters sharded over the one rank and "
              f"equals DP bit for bit ({between[:4]})")
        for tag, n in (("DP", n_cdp), ("fsdp", n_cfs)):
            per = {k: n[k] for k in ("word_pixel_attention", "word_pixel_attention_bwd")}
            check(per == {"word_pixel_attention": 3, "word_pixel_attention_bwd": 3},
                  f"scale coupled {tag}: rows 1 and 1 bwd launched 3 times in its step ({per})")
        del enc, cplain, cdp, cfs, frozen, frozen_dp
        gc.collect()
        torch.cuda.empty_cache()

        # -- (2) the train-state checkpoint ---------------------------------------------
        t = GANTrainer(cfg, 41, text_sd, mesh=mesh)
        s = t.init_state(torch.Generator().manual_seed(0))
        batches = [train_batch(torch, rng, TRAIN_B) for _ in range(4)]

        def timed_step(b):
            t0 = time.perf_counter()
            t.train_step(s, b)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for b in batches[:2]:  # warm-up
            timed_step(b)
        plain_ms = [timed_step(b) for b in batches for _ in range(2)]
        ckpt = os.path.join(tmp, "scale_ckpt")
        save_s, write_s, during_ms, saved_steps = [], [], [], []
        with dcp_io.TrainCheckpointer(ckpt, max_to_keep=2) as w:
            for i, b in enumerate(batches[:3]):
                saved_steps.append(s.step)
                if i == 1:
                    saved = multihost.fetch_to_host(s.state_dict())
                    saved_step = s.step
                t0 = time.perf_counter()
                w.save(s.step, s.state_dict())
                save_s.append(time.perf_counter() - t0)
                during_ms.append(timed_step(b))
                t0 = time.perf_counter()
                w.wait()
                write_s.append(time.perf_counter() - t0 + during_ms[-1])
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs_ in os.walk(
            os.path.join(ckpt, str(saved_step))) for f in fs_)
        back = t.init_state(torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd, _ = dcp_io.restore_train_state(ckpt, back.state_dict(), step=saved_step)
        back.load_state_dict(sd)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = multihost.fetch_to_host(back.state_dict())
        diff = [k for k in saved if not torch.equal(saved[k], got[k])]
        steps_kept = dcp_io.all_steps(ckpt)
        print(f"  scale checkpoint: {nbytes / 2 ** 20:.2f} MiB a step ({len(saved)} tensors), "
              f"save() {1e3 * float(np.median(save_s)):.2f} ms (median of {len(save_s)}; the "
              f"device-to-host copy), save to committed {1e3 * float(np.median(write_s)):.1f} "
              f"ms, restore {1e3 * restore_s:.1f} ms; the f32 step at B = {TRAIN_B} "
              f"{1e3 * float(np.median(plain_ms)):.2f} ms without a write in flight, "
              f"{1e3 * float(np.median(during_ms)):.2f} ms with one (medians, host clock, "
              f"synchronised), on {card}", flush=True)
        check(not diff and steps_kept == saved_steps[-2:],
              f"scale checkpoint: the restored state == the saved one, bit for bit ({diff[:4]}); "
              f"the newest 2 of {saved_steps} kept ({steps_kept})")
        del t, s, back, sd, saved, got
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for v in SCALE_VARS:
            os.environ.pop(v, None)

    # -- (3) the CLI: --mesh 1x1, stopped by SIGTERM, --resume ------------------------------
    data = os.path.join(tmp, "face_train_scale")
    face_train_set(rng, data, 5)
    yml = os.path.join(tmp, "train_faceSR_S8_scale.yml")
    with open(yml, "w") as f:
        f.write(FACE_S8_TRAIN_YAML)
    n_words = TextFaceDataset(data, split="train", words_num=T, imsize=256).n_words
    te = os.path.join(tmp, "scale_text_encoder.pth")
    torch.save(seeded_text_state_dict(cfg, n_words, torch.Generator().manual_seed(15)), te)
    base = ["--cfg", yml, "--data_dir", data, "--text_encoder", te, "--log_every", "1",
            "--mesh", "1x1"]
    whole, part = os.path.join(tmp, "scale_whole"), os.path.join(tmp, "scale_part")
    real_step = GANTrainer.train_step

    def step_then_sigterm(self, state, batch):
        metrics = real_step(self, state, batch)
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)  # as a scheduler stops the run
        return metrics

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # the group of one rank kept: the runs step through the data-parallel
        # code, and --fsdp checkpoints sharded parameters (DTensors)
        with data_parallel.couple_one_rank():
            runs = {"whole": train_gan.main(base + ["--out_dir", whole])}
            GANTrainer.train_step = step_then_sigterm
            try:
                runs["stopped"] = train_gan.main(base + ["--out_dir", part, "--fsdp"])
            finally:
                GANTrainer.train_step = real_step
            runs["resumed"] = train_gan.main(base + ["--out_dir", part, "--resume"])
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
    dt = time.perf_counter() - t0
    snaps = {}
    for tag, out in (("whole", whole), ("resumed", part)):
        for name in ("netG_it4.msgpack", "netGH_it4.msgpack"):
            p = os.path.join(out, "Model", name)
            snaps[tag, name] = open(p, "rb").read() if os.path.exists(p) else None
    r = {tag: (run["start_step"], run["steps"], run["stopped"]) for tag, run in runs.items()}
    print(f"  scale cli (start step, end step, stopped): {r}; three runs in {dt:.1f} s (host "
          f"clock, checkpoints written)", flush=True)
    check(r == {"whole": (0, 4, False), "stopped": (0, 2, True), "resumed": (2, 4, False)}
          and runs["stopped"]["trainer"].fsdp and runs["stopped"]["state"].shards
          and dcp_io.latest_step(runs["stopped"]["ckpt_dir"]),
          "scale cli: --mesh 1x1 runs 4 steps; --mesh 1x1 --fsdp (parameters sharded over the "
          "one rank) stops at the SIGTERM after step 2 with its checkpoint; --resume (no "
          "--fsdp) continues from step 2 to 4")
    check(all(snaps["whole", n] is not None and snaps["whole", n] == snaps["resumed", n]
              for n in ("netG_it4.msgpack", "netGH_it4.msgpack")),
          "scale cli: the resumed run's step-4 snapshot pair == the whole run's, byte for byte")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- x16 training (models16 in GANTrainer, remat, plan_batch) -----------------------

X16_TRAIN_SITES = (32, 64, 128, 256)  # the attention's four sites in an x16 step
X16_SIZES = (64, 128, 256, 512)
X16_CPU_B = 2  # the card's x16 step held against a float64 CPU step
X16_STEPS = 3  # timed steps a path and policy, three to keep the script within its limit
# plan_batch's upper end in x16_train_phase: the four plans lie at 40-88 (PERF.md)
X16_PLAN_HI = 128
# the face S16 training config (configs/train_faceSR_S16.yml at full width)
# for the CLI run: BATCH_SIZE cut to 2 so that the example set's 4 train
# images make 2 steps, one epoch, a snapshot every 2 steps
FACE_S16_TRAIN_YAML = """# face S16 training: x16, 32 px -> 512 px (configs/train_faceSR_S16.yml)
CONFIG_NAME: 'face_S16_train'
METHOD: 'S16'
TREE:
    BRANCH_NUM: 5
    BASE_SIZE: 32
DATASET_NAME: 'face'
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 2
GAN:
    DF_DIM: 64
    GF_DIM: 32
    R_NUM: 2
TEXT:
    EMBEDDING_DIM: 256
    CAPTIONS_PER_IMAGE: 1
"""


def x16_train_config():
    from tgsr_tpu_torch.config import config_from_file

    return config_from_file(os.path.join(HERE, "configs", "train_faceSR_S16.yml"))


def same_bits(torch, a, b) -> list:
    """The names where two (metrics, trainer_readout) runs differ in any bit."""
    (ma, (pa, sa)), (mb, (pb, sb)) = a, b
    out = [k for k in ma if ma[k] != mb[k]]
    out += [n for n in pa if not all(torch.equal(x, y) for x, y in zip(pa[n], pb[n]))]
    return out + [n for n in sa if not torch.equal(sa[n], sb[n])]


def x16_train_kernel_rows(torch) -> dict:
    """Rows 1 and 1 bwd at the four attention sites of an x16 training step
    (B = 16, 32 to 256 px: 1,048,576 pixel rows at 256 px; ragged captions,
    one padded everywhere; no attention-map gradient, as the step runs it),
    each held against its plain version and timed (`attention_phase`,
    `attention_bwd_phase`). Returns {kernel name: its numbers}, which main
    sets under "x16_train" in that kernel's entry."""
    rng = np.random.default_rng(162)
    entries = [attention_phase(torch, rng, X16_TRAIN_SITES, b=X16_TRAIN_B,
                               what="x16 training step"),
               attention_bwd_phase(torch, rng, X16_TRAIN_SITES, b=X16_TRAIN_B, ga_hw=None,
                                   what="x16")]
    return {e["name"]: {k: v for k, v in e.items() if k not in ("name", "route", "source",
                                                                 "replaces")}
            for e in entries}


def x16_train_phase(torch, rng, card, tmp, cpu_jobs):
    """GAN training of the x16 family at full width on the card
    (configs/train_faceSR_S16.yml: BRANCH_NUM 5, 32 px -> 512 px, GF_DIM 32,
    DF_DIM 64, EMBEDDING_DIM 256, T 18; seeded weights, noise images).
    (1) GANTrainer.plan_batch(hi=X16_PLAN_HI) in float32 and bfloat16, each
    with remat False and 'all' (while (4)'s CPU steps run in a thread beside
    them): the four answers and their probes' peaks; a fresh
    run at each nonzero plan peaks under its budget, and 'all' plans at least
    the batch False plans. The same thread then makes the CPU steps of
    `cpu_jobs` ({name: (cfg, text_sd, batch)}: train_phase's and
    eval_variants_phase's), as the plans and then (5) wait on the card and
    leave the host's cores free. (2) X16_STEPS steps at B = 16 (the plan where 16 does
    not fit) per path and policy that fits: finite metrics, 4 attention
    forward launches a step (8 with 'all', whose recompute runs each stage
    again) and 4 backward, ms a step (host clock, synchronised, steps 2 on),
    img/s, peak reserved memory, one profiled step; bf16's first-step
    metrics within 15 % of f32's. (3) The remat='all' step against the
    remat=False step at that B under torch.use_deterministic_algorithms: bit
    for bit where two remat=False steps are (else G's BN running stats
    equal, the rest held by (4)). (4) One float32 step at B = 2 against a
    float64 CPU step (`step_against_cpu`), the card with remat False and
    'all'. (5) The CLI with --remat all for 2 steps; its snapshot pair served
    by the x16 SRPipeline on the card equal to the run's EMA generator.
    (5) runs before (2)-(4), beside the thread's last CPU steps; (2) starts
    when they are done, so that no CPU step runs beside a timed step.
    Returns (the launches of each run, {name: the CPU steps of cpu_jobs})."""
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.cli import train_gan
    from tgsr_tpu_torch.data.datasets import TextFaceDataset
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.ops import _build

    cfg = x16_train_config()
    text_sd = seeded_text_state_dict(cfg, 41, torch.Generator().manual_seed(16))
    launches, plans = {}, {}
    dtypes, policies = (torch.float32, torch.bfloat16), (False, "all")
    name = lambda dtype, remat: f"train x16 {str(dtype).split('.')[-1]} remat {remat}"

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # -- (1) plan_batch -------------------------------------------------------------
    # (4)'s CPU steps, float32 and float64 (about 100 s of the host's CPU), run in
    # a thread of their own beside the plans, which wait on the card
    cpu_batch = train_batch(torch, rng, X16_CPU_B, device="cpu", sizes=X16_SIZES)
    pool = ThreadPoolExecutor(1)
    cpu_runs = pool.submit(cpu_reference_steps, torch, cfg, text_sd, cpu_batch)
    job_runs = {name: pool.submit(cpu_reference_steps, torch, *job)
                for name, job in cpu_jobs.items()}
    for dtype in dtypes:
        for remat in policies:
            tag = name(dtype, remat)
            t = GANTrainer(cfg, 41, text_sd, compute_dtype=dtype, remat=remat)
            t0 = time.perf_counter()
            # the four plans lie at 40-88 at full width (PERF.md)
            plans[dtype, remat] = plan = t.plan_batch(hi=X16_PLAN_HI)
            bp = t.batch_plan
            gib = lambda x: "OOM" if x is None else f"{x / 2 ** 30:.2f} GiB"
            print(f"  {tag}: plan_batch(hi={X16_PLAN_HI}) = {plan} in "
                  f"{time.perf_counter() - t0:.1f} s (budget {gib(bp['budget_bytes'])}; "
                  f"probes' peaks, in the order measured: "
                  f"{', '.join(f'B={b}: {gib(v)}' for b, v in bp['probes'].items())}) "
                  f"on {card}", flush=True)
            if plan:
                need = t.step_peak_bytes(plan, bp["budget_bytes"])
                check(need is not None and need <= bp["budget_bytes"],
                      f"{tag}: a fresh run at the plan, B = {plan}, with the allocator "
                      f"capped at the budget {gib(bp['budget_bytes'])}, completes (peak "
                      f"{gib(need)})")
            del t
            free()
        check(plans[dtype, "all"] >= max(1, plans[dtype, False]),
              f"x16 train {str(dtype).split('.')[-1]}: remat 'all' plans B = "
              f"{plans[dtype, 'all']} >= remat False's {plans[dtype, False]}, and at least 1")
    # -- (5) the CLI, beside the thread's last CPU steps --------------------------------------
    data = os.path.join(tmp, "face_train16")
    face_train_set(rng, data, 5)
    yml = os.path.join(tmp, "train_faceSR_S16.yml")
    with open(yml, "w") as f:
        f.write(FACE_S16_TRAIN_YAML)
    n_words = TextFaceDataset(data, split="train", words_num=T, imsize=512).n_words
    te = os.path.join(tmp, "train16_text_encoder.pth")
    torch.save(seeded_text_state_dict(cfg, n_words, torch.Generator().manual_seed(17)), te)
    out = os.path.join(tmp, "train16_out")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    summary = train_gan.main(["--cfg", yml, "--data_dir", data, "--out_dir", out,
                              "--text_encoder", te, "--remat", "all", "--log_every", "1"])
    dt = time.perf_counter() - t0
    launches["train x16 cli"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k]
                                 for k in _build.LAUNCHES}
    snaps = sorted(os.listdir(os.path.join(out, "Model")))
    print(f"  train x16 cli (--remat all): {summary['steps']} steps in {dt:.2f} s (host clock, "
          f"whole run); snapshots {snaps}", flush=True)
    run = launches["train x16 cli"]
    check(summary["steps"] == 2 and snaps == ["netGH_it2.msgpack", "netG_it2.msgpack"]
          and run["word_pixel_attention"] == 16 and run["word_pixel_attention_bwd"] == 8,
          f"train x16 cli: 2 steps, a snapshot pair at 2, 16 attention forward and 8 backward "
          f"launches ({run['word_pixel_attention']}, {run['word_pixel_attention_bwd']})")
    state, trainer = summary["state"], summary["trainer"]
    pipe = SRPipeline.from_reference_checkpoints(
        trainer.cfg, n_words, os.path.join(out, "Model", "netG_it2.msgpack"),
        text_encoder_path=te)
    b = train_batch(torch, rng, 2, vocab=n_words, sizes=X16_SIZES)
    served = pipe(b["lr"].cpu().numpy(), b["captions"].cpu().numpy(),
                  b["cap_lens"].cpu().numpy())["sr"]
    eager = trainer.super_resolve(state, b)
    err = (served.to(eager.device) - eager).abs().max().item()
    check(tuple(served.shape) == (2, 512, 512, 3) and err <= 1e-3,
          f"train x16 cli: its snapshot pair served by the x16 SRPipeline on the card == the "
          f"run's EMA generator eagerly, 512 px (max abs err {err:.3e} <= 1e-3)")
    del pipe, summary, state, trainer
    free()
    t_wait = time.perf_counter()
    cpu_runs = cpu_runs.result()
    job_runs = {name: f.result() for name, f in job_runs.items()}
    pool.shutdown()
    print(f"  x16 train: waited {time.perf_counter() - t_wait:.1f} s for the CPU steps "
          f"({', '.join(['x16', *cpu_jobs])}) after the plans and the CLI", flush=True)

    # -- (2) X16_STEPS steps a path and policy ------------------------------------------------
    first, steps_b = {}, {}
    for dtype in dtypes:
        for remat in policies:
            tag = name(dtype, remat)
            b = min(X16_TRAIN_B, plans[dtype, remat])
            if not b:
                print(f"  {tag}: no batch fits; not run", flush=True)
                continue
            steps_b[dtype, remat] = b
            batches = [train_batch(torch, np.random.default_rng(160 + i), b, sizes=X16_SIZES)
                       for i in range(X16_STEPS)]
            t = GANTrainer(cfg, 41, text_sd, compute_dtype=dtype, remat=remat)
            s = t.init_state(torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            times, metrics = [], []
            for batch in batches:
                t0 = time.perf_counter()
                metrics.append(t.train_step(s, batch))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches[tag] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in _build.LAUNCHES}
            peak = torch.cuda.max_memory_reserved() / 2 ** 30
            vals = [{k: float(v) for k, v in m.items()} for m in metrics]
            first[dtype, remat] = vals[0]
            check(all(np.isfinite(v) for m in vals for v in m.values()),
                  f"{tag}: {X16_STEPS} steps at B = {b}, every metric finite")
            per = {k: launches[tag][k] / X16_STEPS
                   for k in ("word_pixel_attention", "word_pixel_attention_bwd")}
            want = {"word_pixel_attention": 8 if remat else 4, "word_pixel_attention_bwd": 4}
            check(per == want, f"{tag}: {want['word_pixel_attention']} attention forward (4 a "
                               f"step{' and their recompute' if remat else ''}) and 4 backward "
                               f"launches a step ({per})")
            ms = 1e3 * float(np.mean(times[1:]))
            TRAIN_MS[tag] = ms
            print(f"  {tag}: step {ms:.2f} ms at B = {b} (host clock, synchronised, mean of "
                  f"steps 2-{X16_STEPS}; first {1e3 * times[0]:.1f}), {b * 1e3 / ms:.1f} img/s, "
                  f"peak reserved {peak:.2f} GiB, on {card}; d_loss {vals[0]['d_loss']:.4f} -> "
                  f"{vals[-1]['d_loss']:.4f}, pixel {vals[0]['pixel']:.4f} -> "
                  f"{vals[-1]['pixel']:.4f}", flush=True)
            profile_step(torch, lambda: t.train_step(s, batches[0]), tag, b=b)
            del t, s, batches
            free()
    for remat in policies:
        if (torch.float32, remat) in first and (torch.bfloat16, remat) in first and \
                steps_b[torch.float32, remat] == steps_b[torch.bfloat16, remat]:
            f32, bf16 = first[torch.float32, remat], first[torch.bfloat16, remat]
            worst = max(abs(bf16[k] - v) / abs(v) for k, v in f32.items() if abs(v) > 1e-3)
            check(worst < 0.15, f"train x16 remat {remat}: bf16 first-step metrics within 15 % "
                                f"of f32's (worst {worst:.3%})")

    # -- (3) remat against no remat, the same B -------------------------------------------
    b = steps_b.get((torch.float32, False)) or steps_b[torch.float32, "all"]
    batch = train_batch(torch, np.random.default_rng(161), b, sizes=X16_SIZES)

    def one(remat):
        t = GANTrainer(cfg, 41, text_sd, remat=remat)
        s = t.init_state(torch.Generator().manual_seed(0))
        m = {k: float(v) for k, v in t.train_step(s, batch).items()}
        out = (m, trainer_readout(torch, s))
        del t, s
        free()
        return out

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs = [one(False), one(False), one("all")]
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                  if "deterministic" in str(w.message)})
    twice = same_bits(torch, runs[0], runs[1])
    diff = same_bits(torch, runs[0], runs[2])
    g_stats = [n for n in runs[0][1][1] if not n.startswith("d.")]
    print(f"  x16 f32 remat 'all' against remat False at B = {b}, deterministic algorithms "
          f"({len(ops)} ops without one: {ops[:4]}): two remat=False steps differ in "
          f"{len(twice)} tensors, remat 'all' in {len(diff)} ({diff[:4]})", flush=True)
    if not twice:
        check(not diff, f"x16 f32: the remat 'all' step == the remat=False step at B = {b}, "
                        f"bit for bit (metrics, parameters, Adam moments, BN running stats)")
    else:
        check(not [n for n in diff if n in g_stats],
              f"x16 f32: remat 'all' leaves G's BN running stats of the remat=False step at "
              f"B = {b} (the card's step is not bit-reproducible here: step_against_cpu holds "
              f"the rest)")

    # -- (4) the card's step against a float64 CPU step -------------------------------------
    step_against_cpu(torch, cfg, text_sd, cpu_batch, remats=(False, "all"),
                     cpu_runs=cpu_runs)
    free()

    return launches, job_runs


# -- DAMSM (the image encoder, the DAMSM trainer and CLI, the GAN trainer's
# DAMSM terms, R-precision) -----------------------------------------------------

DAMSM_B = 48  # TRAIN.BATCH_SIZE of AttnGAN's cfg/DAMSM/bird.yml; face.yml 32-48
DAMSM_CPU_B = 8  # the card step held against the CPU's
RANK_PEAK_GIB = 8  # rank_memory: the ranking's own memory at N = 5,000
# the DAMSM face configuration (cfg/DAMSM/face.yml's geometry: BRANCH_NUM 1,
# 299 px, T 18, EMBEDDING_DIM 256, gammas 4 / 5 / 10) for the CLI runs, its
# BATCH_SIZE cut to 4 so that the face set's 8 train images make 2 steps
DAMSM_FACE_YAML = """# DAMSM face: text and image encoders at 299 px (cfg/DAMSM/face.yml)
CONFIG_NAME: 'DAMSM_face'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 1
    BASE_SIZE: 299
TEXT:
    EMBEDDING_DIM: 256
    WORDS_NUM: 18
    CAPTIONS_PER_IMAGE: 1
TRAIN:
    FLAG: True
    BATCH_SIZE: 4
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 1
    ENCODER_LR: 0.002
    SMOOTH:
        GAMMA1: 4.0
        GAMMA2: 5.0
        GAMMA3: 10.0
"""


def damsm_config():
    """The DAMSM face configuration at full width, B = DAMSM_B."""
    import dataclasses

    from tgsr_tpu_torch.config import Config, SmoothConfig, TextConfig, TrainConfig, TreeConfig

    return Config(DATASET_NAME="face", TREE=TreeConfig(BRANCH_NUM=1, BASE_SIZE=299),
                  TEXT=TextConfig(EMBEDDING_DIM=256, WORDS_NUM=T),
                  TRAIN=dataclasses.replace(TrainConfig(), BATCH_SIZE=DAMSM_B, ENCODER_LR=0.002,
                                            SMOOTH=SmoothConfig(4.0, 5.0, 10.0)))


def damsm_batch(rng, b, vocab=41, size=299):
    """A correlated DAMSM batch (tests/test_damsm_trainer.py's task): each
    image's level (with noise) encodes its caption's first token; ragged
    captions of 2-18 tokens."""
    first = rng.integers(1, vocab, b)
    lens = rng.integers(2, T + 1, b)
    caps = rng.integers(1, vocab, (b, T))
    caps[:, 0] = first
    caps[np.arange(T)[None, :] >= lens[:, None]] = 0
    level = (first * 255) // vocab
    hr = level[:, None, None, None] + rng.normal(0, 8, (b, size, size, 3))
    return {"hr": np.clip(hr, 0, 255).astype(np.uint8), "captions": caps.astype(np.int32),
            "cap_lens": lens.astype(np.int32), "class_ids": np.arange(b, dtype=np.int32)}


def damsm_readout(torch, t, s):
    """(gradients from Adam's first moment, the parameters, the BN running
    stats) of a DAMSM state after its first step, on the CPU."""
    grads, params = {}, {}
    for n, p in t.trainable(s.text, s.cnn):
        grads[n] = (s.opt.state[p]["exp_avg"] / 0.5).cpu()
        params[n] = p.detach().cpu()
    stats = {k: v.cpu() for k, v in s.cnn.state_dict().items() if "running" in k}
    return grads, params, stats


def damsm_step_against_cpu(torch, cfg, b):
    """One float32 DAMSM step (Inception, B = DAMSM_CPU_B) on the card and on
    the CPU from one seeded init, batch and dropout. Gates (PR 14's lesson:
    per-tensor relative L2, not per-element): metrics rtol 1e-4; each
    trainable gradient within relative L2 1e-3 of the CPU's (94 float32
    convolutions and BNs in another order before the heads); the BN running
    stats within 1e-4 (|x| + 1); the parameters through that gate: the
    card's step is Adam's on the card's own moments (within 1e-6 of lr
    m_hat / (sqrt(v_hat) + eps) recomputed from them)."""
    from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer

    out = {}
    for device in ("cpu", "cuda"):
        t = DAMSMTrainer(cfg, 41, seed=7, device=device)
        s = t.init_state(torch.Generator().manual_seed(0))
        before = {n: p.detach().cpu().clone() for n, p in t.trainable(s.text, s.cnn)}
        t0 = time.perf_counter()
        m = t.train_step(s, t.device_batch(b), t.epoch_lr(0))
        m = {k: float(v) for k, v in m.items()}
        print(f"  damsm step f32 B={len(b['hr'])} on {device}: {time.perf_counter() - t0:.2f} s "
              f"(host clock, first step)", flush=True)
        out[device] = (m, *damsm_readout(torch, t, s), before, t.epoch_lr(0))
    (mc, gc, pc, sc, _, _), (mg, gg, pg, sg, before, lr) = out["cpu"], out["cuda"]
    worst, key = max((abs(mg[k] - v) / abs(v), k) for k, v in mc.items())
    check(worst <= 1e-4, f"damsm step card vs CPU (B = {DAMSM_CPU_B}, Inception, f32): metrics "
                         f"within rtol 1e-4 (worst {key} {worst:.2e})")
    rel = {n: ((gg[n] - ref).norm() / ref.norm().clamp(min=1e-30)).item() for n, ref in gc.items()}
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    check(max(rel.values()) <= 1e-3,
          f"damsm step card vs CPU: {len(rel)} gradient tensors within relative L2 1e-3 (worst "
          + ", ".join(f"{n} {r:.2e}" for n, r in top) + ")")
    bad = [k for k, ref in sc.items() if not ((sg[k] - ref).abs() <= 1e-4 * (ref.abs() + 1)).all()]
    err = max(((sg[k] - ref).abs() / (ref.abs() + 1)).max().item() for k, ref in sc.items())
    check(not bad, f"damsm step card vs CPU: {len(sc)} BN running stats within 1e-4 (|x| + 1) "
                   f"(worst {err:.2e}{'; ' + bad[0] if bad else ''})")
    worst = 0.0
    for n, g in gg.items():
        # after one step m_hat = g and v_hat = g^2: the update is lr g / (|g| + eps)
        want = before[n] - lr * g / (g.abs() + 1e-8)
        worst = max(worst, (pg[n] - want).abs().max().item())
    check(worst <= 1e-6, f"damsm step card: parameters = Adam's first step on the card's own "
                         f"gated gradients (max error {worst:.2e} <= 1e-6)")


def damsm_face_data(rng, tmp):
    """The face set (face_train_set, 9 images: 8 train, 1 test) and the
    DAMSM YAML; returns (data dir, yml path, its vocabulary)."""
    from tgsr_tpu_torch.data.datasets import TextFaceDataset

    data = os.path.join(tmp, "damsm_face")
    face_train_set(rng, data, 9)
    yml = os.path.join(tmp, "DAMSM_face.yml")
    with open(yml, "w") as f:
        f.write(DAMSM_FACE_YAML)
    return data, yml, TextFaceDataset(data, split="train", words_num=T, imsize=299).vocab


def damsm_rank_set(rng, tmp, vocab, n=64):
    """n generated 256 px SR images (ramps and noise) and their captions
    (testset.txt, 'name|flags' over CelebA's attributes, the words the
    vocabulary knows) and testset.pickle; returns (data dir, image dir,
    pickle)."""
    from tgsr_tpu_torch.data.codec import encode_png

    data, images = os.path.join(tmp, "rank"), os.path.join(tmp, "rank", "sr")
    os.makedirs(images)
    known = [k for k, a in enumerate(CELEBA_ATTRS) if a in vocab.wordtoix]
    yy, xx = np.mgrid[:256, :256]
    with open(os.path.join(data, "testset.txt"), "w") as f:
        f.write(" ".join(CELEBA_ATTRS) + " \n")
        for i in range(n):
            r = np.zeros(40, int)
            r[rng.choice(known, min(len(known), rng.integers(1, 4)), replace=False)] = 1
            f.write(f"{i:06d}.png|{i:06d}.jpg " + " ".join(map(str, r)) + "\n")
            img = np.stack([(yy * rng.uniform(0.3, 1.5) + xx * rng.uniform(0.3, 1.5)) % 256
                            for _ in range(3)], -1)
            img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype("uint8")
            with open(os.path.join(images, f"{i:06d}.png"), "wb") as g:
                g.write(encode_png(img))
    pkl = os.path.join(data, "testset.pickle")
    with open(pkl, "wb") as f:
        pickle.dump([[], vocab.ixtoword, vocab.wordtoix], f, protocol=2)
    return data, images, pkl


def damsm_phase(torch, rng, card, tmp):
    """DAMSM on the card at the face configuration's full width. (1) Ten
    DAMSMTrainer steps at B = 48 with the seeded Inception-v3 CNNEncoder at
    299 px, float32 and bfloat16, on a correlated synthetic set: finite
    metrics, the held-out loss falls, bf16's first-step metrics within 10 %
    of f32's, the mean ms a step, img/s, peak reserved memory and one
    profiled step; one step at B = 8 against the CPU's
    (`damsm_step_against_cpu`). (2) `tgsr_tpu_torch.cli.pretrain_damsm` on a
    face set, SimpleCNN and Inception, one epoch each, and a resume from
    SimpleCNN's text_encoder0: snapshot pairs and attention grids. (3) The
    GAN trainer with the DAMSM terms (face S8, full width): ten steps at B =
    16 with the SimpleCNN snapshot, f32 and bf16, 3 + 3 attention launches a
    step, ms a step beside train_phase's without the terms; the card's step
    against a float64 CPU step (`step_against_cpu`, D frozen, terms on), and
    SimpleCNN's backward alone on that step's fake (`damsm_input_grads`,
    DAMSM_ELEMENT_RATIO; the terms alone, `damsm_term_grads`, printed); the
    Inception snapshot's terms have no gradient path to G's fake,
    SimpleCNN's move G's gradients; `cli.train_gan --image_encoder`. (4)
    `tgsr_tpu_torch.cli.eval_rank` on 64 SR images with both snapshots (R@1,
    R@5), and the similarity matrices of the card against the CPU's; the
    ranking's time and peak memory at N = 1,000 and 5,000 (`rank_memory`).
    main runs it under PyTorch's default TF32 switches, which the trainers
    and the ranking override. Returns the launches of each run."""
    import copy

    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.cli import eval_rank, pretrain_damsm, train_gan
    from tgsr_tpu_torch.config import Config, face_s8_config
    from tgsr_tpu_torch.data.datasets import TextFaceDataset, TextSRGTDataset
    from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer
    from tgsr_tpu_torch.engine.evaluator import _rank_sims
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.losses.damsm import sent_loss, words_loss
    from tgsr_tpu_torch.ops import _build

    launches = {}
    cfg = damsm_config()
    # -- (1) DAMSM steps at B = 48, f32 and bf16 ---------------------------------------
    t0 = time.perf_counter()
    batches = [damsm_batch(rng, DAMSM_B) for _ in range(10)]
    held = damsm_batch(rng, DAMSM_B)
    first = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "damsm " + str(dtype).split(".")[-1]
        t = DAMSMTrainer(cfg, 41, compute_dtype=dtype, seed=3)
        s = t.init_state(torch.Generator().manual_seed(0))
        hb = t.device_batch(held)
        loss0 = float(t.eval_step(s, hb)[0]["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for b in batches:
            db = t.device_batch(b)
            t1 = time.perf_counter()
            metrics.append(t.train_step(s, db, t.epoch_lr(0)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_reserved() / 2 ** 30
        vals = [{k: float(v) for k, v in m.items()} for m in metrics]
        loss1 = float(t.eval_step(s, hb)[0]["loss"])
        first[dtype] = vals[0]
        check(all(np.isfinite(v) for m in vals for v in m.values()) and loss1 < loss0,
              f"{tag}: 10 steps at B = {DAMSM_B} (Inception-v3, 299 px), every metric finite, "
              f"the held-out loss falls ({loss0:.4f} -> {loss1:.4f})")
        ms = 1e3 * float(np.mean(times[1:]))
        print(f"  {tag}: step {ms:.2f} ms (host clock, synchronised, mean of steps 2-10; first "
              f"{1e3 * times[0]:.1f}, the batch's copy to the card not included), "
              f"{DAMSM_B * 1e3 / ms:.1f} img/s, peak reserved {peak:.2f} GiB, on {card}; loss "
              f"{vals[0]['loss']:.4f} -> {vals[-1]['loss']:.4f}", flush=True)
        db = t.device_batch(batches[0])
        profile_step(torch, lambda: t.train_step(s, db, t.epoch_lr(0)), tag, b=DAMSM_B)
        del t, s, hb, db
        gc.collect()
        torch.cuda.empty_cache()
    worst = max(abs(first[torch.bfloat16][k] - v) / abs(v)
                for k, v in first[torch.float32].items() if abs(v) > 1e-3)
    check(worst < 0.1, f"damsm bf16 first-step metrics within 10 % of f32's (worst {worst:.3%})")
    cpu_b = damsm_batch(rng, DAMSM_CPU_B)
    damsm_step_against_cpu(torch, cfg, cpu_b)
    print(f"  damsm steps: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- (2) the pretraining CLI, both families, and a resume ----------------------------
    t0 = time.perf_counter()
    data, yml, vocab = damsm_face_data(rng, tmp)
    runs = {}
    for family, extra in (("simple", ["--simple-cnn"]), ("inception", [])):
        t1 = time.perf_counter()
        out = os.path.join(tmp, f"damsm_{family}")
        runs[family] = pretrain_damsm.main(["--cfg", yml, "--data_dir", data, "--out_dir", out,
                                            "--manualSeed", "5", *extra])
        files = sorted(os.listdir(os.path.join(runs[family]["out_dir"], "Model")))
        grid = os.path.join(runs[family]["out_dir"], "Image", "attention_maps0.png")
        check(files == ["image_encoder0.msgpack", "text_encoder0.msgpack"]
              and os.path.getsize(grid) > 0,
              f"cli.pretrain_damsm {family}: one epoch ({len(runs[family]['history'])} history "
              f"rows), the snapshot pair and the attention grid written "
              f"({time.perf_counter() - t1:.1f} s, host clock)")
    snap = {f: os.path.join(r["out_dir"], "Model") for f, r in runs.items()}
    t1 = time.perf_counter()
    resumed = pretrain_damsm.main(["--cfg", yml, "--data_dir", data, "--out_dir",
                                   os.path.join(tmp, "damsm_resumed"), "--manualSeed", "5",
                                   "--simple-cnn", "--epochs", "2", "--resume_from",
                                   os.path.join(snap["simple"], "text_encoder0.msgpack")])
    files = sorted(os.listdir(os.path.join(resumed["out_dir"], "Model")))
    check(resumed["start_epoch"] == 1 and files == ["image_encoder1.msgpack",
                                                    "text_encoder1.msgpack"],
          f"cli.pretrain_damsm --resume_from text_encoder0: epoch 1 trained and snapshotted "
          f"({time.perf_counter() - t1:.1f} s)")
    print(f"  damsm cli: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- (3) the GAN trainer's DAMSM terms ----------------------------------------------
    t0 = time.perf_counter()
    gcfg = face_s8_config()
    text_sd = seeded_text_state_dict(gcfg, 41, torch.Generator().manual_seed(14))
    simple = train_gan.load_image_encoder_module(
        os.path.join(snap["simple"], "image_encoder0.msgpack"), 256)
    inception = train_gan.load_image_encoder_module(
        os.path.join(snap["inception"], "image_encoder0.msgpack"), 256)
    gbatches = [train_batch(torch, rng, TRAIN_B, empty=False) for _ in range(10)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tag = f"damsm gan {name}"
        t = GANTrainer(gcfg, 41, text_sd, compute_dtype=dtype, image_encoder=copy.deepcopy(simple))
        s = t.init_state(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        times, metrics = [], []
        for b in gbatches:
            t1 = time.perf_counter()
            metrics.append(t.train_step(s, b))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        launches[tag] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in _build.LAUNCHES}
        vals = [{k: float(v) for k, v in m.items()} for m in metrics]
        per = {k: launches[tag][k] / 10
               for k in ("word_pixel_attention", "word_pixel_attention_bwd")}
        check(all(np.isfinite(v) for m in vals for v in m.values()) and "w_loss" in vals[0]
              and per == {"word_pixel_attention": 3, "word_pixel_attention_bwd": 3},
              f"{tag}: 10 steps at B = {TRAIN_B} with SimpleCNN's DAMSM terms, every metric "
              f"finite (w_loss {vals[0]['w_loss']:.4f}, s_loss {vals[0]['s_loss']:.4f}), 3 "
              f"attention forward and 3 backward launches a step ({per})")
        ms = 1e3 * float(np.mean(times[1:]))
        plain = TRAIN_MS.get(f"train {name}")
        print(f"  {tag}: step {ms:.2f} ms (host clock, synchronised, mean of steps 2-10), "
              f"{TRAIN_B * 1e3 / ms:.1f} img/s, peak reserved "
              f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB, on {card}; without the "
              f"terms (train phase, this run) "
              + (f"{plain:.2f} ms, x{ms / plain:.3f}" if plain else "not measured"), flush=True)
        profile_step(torch, lambda: t.train_step(s, gbatches[0]), tag)
        del t, s
        gc.collect()
        torch.cuda.empty_cache()
    b4 = train_batch(torch, rng, 4, device="cpu", empty=False)
    step_against_cpu(torch, gcfg, text_sd, b4, image_encoder=simple, d_lrs=(0.0,))
    diag = damsm_input_grads(torch, simple, text_sd, b4, damsm_fake(torch, gcfg, text_sd, b4,
                                                                     simple))
    print("  damsm gan, SimpleCNN's backward alone on that step's fake, relative L2 against "
          "float64 (a: whole; b: from the float32 resize, ReLU flips): " + "; ".join(
              f"{p} {r} {v:.3g}" for (p, r), v in diag.items()), flush=True)
    for run in ("cuDNN off", "cuDNN on"):
        r = diag["b", f"{run} median element error / the CPU's"]
        control = diag["b", "control x (1 + 0.001) median element error / the CPU's"]
        check(r <= DAMSM_ELEMENT_RATIO,
              f"damsm gan ({run}): SimpleCNN's backward alone on the step's fake, from the "
              f"float32 resize: the median element's error against float64 {r:.3g} times the "
              f"CPU's (<= {DAMSM_ELEMENT_RATIO}; the gradient 1e-3 off reads {control:.3g})")
    diag = damsm_term_grads(torch, gcfg, text_sd, b4, simple)
    print("  damsm gan, the DAMSM terms alone in that step, each run on its own fake, against "
          "float64: " + "; ".join(f"{p} {r} {v:.3g}" for (p, r), v in diag.items()), flush=True)
    # the Inception family's terms give G no gradient, SimpleCNN's do. Exact:
    # the Inception terms' loss on G's fake has no autograd path to it (the
    # backbone runs without autograd, JAX's freeze_backbone); comparing G's
    # gradients with and without them on the card only compares cuDNN's
    # run-to-run noise (the script's final run: 1.87e-04 against 8.27e-05).
    # SimpleCNN's terms move G's gradients (D frozen: Adam's sign-following
    # first D step would make G's gradient part run to run)
    b4 = train_batch(torch, rng, 4, empty=False)
    path = {}
    for fam, enc in (("inception", inception), ("simple", simple)):
        t = GANTrainer(gcfg, 41, text_sd, image_encoder=copy.deepcopy(enc), d_lr=0.0)
        s = t.init_state(torch.Generator().manual_seed(0))
        lr, words, sent, mask = t._inputs(b4)
        img = t._generate(s, lr, words, sent, mask)[1][-1]
        feat, code = t._encode(img)
        w0, w1, _ = words_loss(feat, words, b4["cap_lens"], None, *t.gammas)
        s0, s1 = sent_loss(code, sent, None, t.gammas[2])
        path[fam] = (img.requires_grad, (w0 + w1 + s0 + s1).requires_grad,
                     float((w0 + w1).detach()))
        del t, s
    g = {}
    for fam, enc in (("none", None), ("simple", simple)):
        t = GANTrainer(gcfg, 41, text_sd, image_encoder=copy.deepcopy(enc), d_lr=0.0)
        s = t.init_state(torch.Generator().manual_seed(0))
        t.train_step(s, b4)
        g[fam] = {n: s.g_opt.state[p]["exp_avg"].clone() for n, p in s.g_named_parameters()}
        del t, s
    moved = max(((g["simple"][n] - ref).norm() / ref.norm().clamp(min=1e-30)).item()
                for n, ref in g["none"].items())
    check(path["inception"][:2] == (True, False) and path["simple"][:2] == (True, True)
          and path["inception"][2] > 0 and moved >= 1e-2,
          f"damsm gan: the Inception snapshot's terms (w_loss {path['inception'][2]:.4f}) have no "
          f"gradient path to G's fake (JAX's freeze_backbone), SimpleCNN's (w_loss "
          f"{path['simple'][2]:.4f}) have one and move G's gradients by {moved:.2e} (>= 1e-2, "
          f"D frozen)")
    cli_data = os.path.join(tmp, "damsm_gan_face")
    face_train_set(rng, cli_data, 5)
    gyml = os.path.join(tmp, "train_faceSR_S8_damsm.yml")
    with open(gyml, "w") as f:
        f.write(FACE_S8_TRAIN_YAML)
    n_words = TextFaceDataset(cli_data, split="train", words_num=T, imsize=256).n_words
    te = os.path.join(tmp, "damsm_gan_text_encoder.pth")
    torch.save(seeded_text_state_dict(gcfg, n_words, torch.Generator().manual_seed(15)), te)
    out = os.path.join(tmp, "damsm_gan_out")
    _build.reset_launches()
    t1 = time.perf_counter()
    summary = train_gan.main(["--cfg", gyml, "--data_dir", cli_data, "--out_dir", out,
                              "--text_encoder", te, "--epochs", "1", "--log_every", "1",
                              "--image_encoder",
                              os.path.join(snap["simple"], "image_encoder0.msgpack")])
    launches["damsm gan cli"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k]
                                 for k in _build.LAUNCHES}
    with open(os.path.join(out, "Log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(summary["steps"] == 2 and all("w_loss" in r and "s_loss" in r for r in rows)
          and launches["damsm gan cli"]["word_pixel_attention_bwd"] == 6,
          f"cli.train_gan --image_encoder (SimpleCNN snapshot): {summary['steps']} steps, "
          f"w_loss and s_loss in every row, 6 backward launches "
          f"({time.perf_counter() - t1:.1f} s)")
    del summary
    print(f"  damsm gan: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- (4) R-precision ----------------------------------------------------------------
    t0 = time.perf_counter()
    rdata, rimages, pkl = damsm_rank_set(rng, tmp, vocab)
    base = ["--data_dir", rdata, "--image_dir", rimages, "--vocab_pickle", pkl]
    ecfg = Config()
    for fam, extra in (("simple", ["--simple-cnn"]), ("inception", [])):
        enc = ["--net_e", os.path.join(snap[fam], "text_encoder0.msgpack"), "--image_encoder",
               os.path.join(snap[fam], "image_encoder0.msgpack"), *extra]
        t1 = time.perf_counter()
        res = eval_rank.main(base + enc)
        dt = time.perf_counter() - t1
        check(res["n"] == 64 and res["seeded_encoders"] == [] and all(
            0 <= res[k] <= 1 for k in ("word_r@1", "sent_r@1", "word_r@5", "sent_r@5")),
              f"cli.eval_rank {fam}: 64 images, word R@1 {res['word_r@1']:.4f}, R@5 "
              f"{res['word_r@5']:.4f}, sentence R@1 {res['sent_r@1']:.4f}, R@5 "
              f"{res['sent_r@5']:.4f} ({dt:.1f} s, host clock)")
        args = eval_rank.build_parser().parse_args(base + enc)
        ds = TextSRGTDataset(eval_rank.load_vocab(pkl), rdata, rimages, dataset="face",
                             words_num=ecfg.TEXT.WORDS_NUM, imsize=256)
        sims = {}
        for device in ("cuda", "cpu"):
            text_enc, cnn_enc, _ = eval_rank.load_encoders(args, ecfg, vocab.n_words,
                                                           torch.device(device))
            x = eval_rank.embed_all(ds, text_enc, cnn_enc, args.batch, torch.device(device))
            sm = ecfg.TRAIN.SMOOTH
            sims[device] = [m.cpu() for m in _rank_sims(*x, sm.GAMMA1, sm.GAMMA2, sm.GAMMA3)]
        for what, card_m, cpu_m in zip(("word", "sentence"), sims["cuda"], sims["cpu"]):
            tol = 1e-4 * (cpu_m.abs() + 1)
            err = ((card_m - cpu_m).abs() / (cpu_m.abs() + 1)).max().item()
            own = cpu_m.diagonal()
            clear = ~(((cpu_m - own[:, None]).abs() <= tol) & ~torch.eye(64, dtype=torch.bool)
                      ).any(1)
            rank = lambda m: (m > m.diagonal()[:, None]).sum(1)
            same = (rank(card_m) == rank(cpu_m))[clear].all().item()
            check(err <= 1e-4 and same,
                  f"cli.eval_rank {fam}: {what} similarities on the card within 1e-4 (|cpu| + 1) "
                  f"of the CPU's (worst {err:.2e}), each own caption's rank the same in the "
                  f"{int(clear.sum())} rows with no score within that of it")
    rank_memory(torch, card)
    print(f"  damsm rank: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def rank_memory(torch, card) -> None:
    """`_rank_sims` at test-set sizes on seeded embeddings (T 18, 289
    regions, nef 256, every caption 18 words): host ms (synchronised) and
    the peak memory it allocates beyond its inputs, held below RANK_PEAK_GIB
    (the captions in blocks; the whole [N, N, T, R] attention would be
    N^2 T R 4 bytes a tensor)."""
    from tgsr_tpu_torch.engine.evaluator import _rank_sims

    g = torch.Generator(device="cuda").manual_seed(9)
    for n in (1000, 5000):
        x = [torch.randn(s, generator=g, device="cuda")
             for s in ((n, 289, 256), (n, 256), (n, T, 256), (n, 256))]
        lens = torch.full((n,), T, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        w, s_ = _rank_sims(*x, lens, 4.0, 5.0, 10.0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        whole = n * n * T * 289 * 4 / 2 ** 30
        check(w.shape == s_.shape == (n, n) and bool(torch.isfinite(w).all())
              and peak <= RANK_PEAK_GIB,
              f"damsm rank at N = {n}: the [N, N] similarities in {ms:.1f} ms (host clock, "
              f"synchronised), peak {peak:.2f} GiB beyond the inputs (<= {RANK_PEAK_GIB}; "
              f"one whole [N, N, T, R] tensor {whole:.1f} GiB), on {card}")
        del x, w, s_
        torch.cuda.empty_cache()


def profile_forward(torch, fn, tag: str, how: str, b: int, top: int = 12) -> None:
    """Device time of one B=64 forward, fn(), by kernel (torch.profiler,
    CUPTI), and the share of cuDNN's layout conversions; `how` is "eager"
    or "replay" (of the captured graph)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # nothing queued before fn() counts in its wall time
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("  profile: no device time recorded (not measured)", flush=True)
        return
    print(f"  profile of one {tag} forward at B={b}, {how}: device {dev:.3f} ms, "
          f"wall {wall:.3f} ms under the profiler, idle share "
          f"{max(0.0, 1 - dev / wall):.3f}, {sum(e.count for e in events)} kernels",
          flush=True)
    conv = [e for e in events if "nchwToNhwc" in e.key or "nhwcToNchw" in e.key]
    conv_ms = sum(e.self_device_time_total for e in conv) / 1e3
    print(f"    layout conversions: {sum(e.count for e in conv)} launches, "
          f"{conv_ms:.3f} ms, {conv_ms / dev:.1%}", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:9.3f} ms {ms / dev:6.1%} x{e.count:<4d} {e.key[:90]}", flush=True)


def damsm_fake(torch, cfg, text_sd, batch, enc):
    """The finest fake image G makes in `step_against_cpu`'s first step on
    `batch` (its trainers' seeded init, train mode), NHWC float64 on the
    CPU: what the image encoder sees in that step."""
    import copy

    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.ops.blocks import nhwc

    t = GANTrainer(cfg, 41, text_sd, compute_dtype=torch.float64, device="cpu", d_lr=0.0,
                   image_encoder=copy.deepcopy(enc))
    s = t.init_state(torch.Generator().manual_seed(0))
    s.netg.train()
    s.netgh.train()
    with torch.no_grad():
        lr, words, sent, mask = t._inputs(batch)
        return nhwc(t._generate(s, lr, words, sent, mask)[1][-1])


def damsm_term_grads(torch, cfg, text_sd, batch, enc) -> dict:
    """The DAMSM terms alone in `step_against_cpu`'s G step (D frozen): each
    run (the CPU in float32, the card with cuDNN off and on) makes its own
    fake from the trainers' seeded init, encodes it and takes the words +
    sentence losses' gradient into that fake and into G's parameters. Each
    against the CPU's float64: the fake's and the image gradient's relative
    L2 errors, and the median of G's gradient tensors in the gate's units
    (twice the CPU float32 run's error + 1e-5 |g|). Returns {(what, run):
    number}."""
    import copy

    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.losses.damsm import sent_loss, words_loss

    got = {}
    for run, device, dtype, cudnn in (("f64", "cpu", torch.float64, True),
                                      ("cpu", "cpu", torch.float32, True),
                                      ("cuDNN off", "cuda", torch.float32, False),
                                      ("cuDNN on", "cuda", torch.float32, True)):
        t = GANTrainer(cfg, 41, text_sd, compute_dtype=dtype, device=device, d_lr=0.0,
                       image_encoder=copy.deepcopy(enc))
        s = t.init_state(torch.Generator().manual_seed(0))
        s.netg.train()
        s.netgh.train()
        names, params = zip(*s.g_named_parameters())
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            lr, words, sent, mask = t._inputs(batch)
            img = t._generate(s, lr, words, sent, mask)[1][-1]
            feat, code = t._encode(img)
            lt = t.loss_dtype
            lens = torch.as_tensor(batch["cap_lens"], device=t.device)
            w0, w1, _ = words_loss(feat, words.to(lt), lens, None, *t.gammas)
            s0, s1 = sent_loss(code, sent.to(lt), None, t.gammas[2])
            grads = torch.autograd.grad(w0 + w1 + s0 + s1, [img, *params], allow_unused=True)
        # the parameters that the finest fake does not read get no gradient
        got[run] = [x.detach().double().cpu() for x in (img, *grads) if x is not None]
    ref, cpu = got["f64"], got["cpu"]
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
    out = {}
    for run in ("cpu", "cuDNN off", "cuDNN on"):
        x = got[run]
        out["fake", run] = rel(x[0], ref[0])
        out["image gradient", run] = rel(x[1], ref[1])
        units = [(a - r).norm().item() / (2 * (c - r).norm().item() + 1e-5 * r.norm().item())
                 for a, c, r in zip(x[2:], cpu[2:], ref[2:])]
        out["G median units", run] = float(np.median(units))
    return out


def damsm_input_grads(torch, enc, text_sd, batch, img) -> dict:
    """SimpleCNN's backward alone: the gradient of the DAMSM words and
    sentence losses (the seeded text encoder's embeddings of the batch's
    captions) into `img` (NHWC, 256 px; `damsm_fake`), through `enc` in
    eval mode as the GAN trainer runs it, on the CPU in float32 and on the
    card with cuDNN off and on, each against the CPU's float64: (a) the
    whole encoder, its resize matrices float64 in the float64 run; (b) from
    the 137 px input the CPU's float32 resize gives, so that only the
    arithmetic of the convolutions, BNs and losses differs, with the ReLUs
    whose input has another sign than in float64. Also how many entries of
    the 256 -> 137 resize matrix the card computes otherwise than the CPU.
    Returns {(a|b|matrix, what): number}."""
    import copy

    from tgsr_tpu_torch.losses.damsm import sent_loss, words_loss
    from tgsr_tpu_torch.models.image_encoder import SIMPLE_SIZE
    from tgsr_tpu_torch.models.text_encoder import TextEncoder
    from tgsr_tpu_torch.ops.image import resize, resize_weights

    text = TextEncoder(41, 300, 256)
    text.load_state_dict(text_sd)
    with torch.no_grad():
        words, sent = text.eval()(batch["captions"].long(), batch["cap_lens"].long())
    small = resize(img.float().cpu(), (SIMPLE_SIZE, SIMPLE_SIZE), "bilinear")

    def grad(x, device, dtype, cudnn):
        e = copy.deepcopy(enc).to(device, dtype).eval()
        acts = []
        for name in ("bn0", "bn1", "bn2", "conv_17"):  # the ReLUs' inputs
            getattr(e, name).register_forward_hook(lambda m, i, o: acts.append(o.detach().cpu()))
        x = x.to(device, dtype).requires_grad_()
        lens = batch["cap_lens"].to(device)
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            feat, code = e(x)
            w0, w1, _ = words_loss(feat, words.to(device, dtype), lens, None, 4.0, 5.0, 10.0)
            s0, s1 = sent_loss(code, sent.to(device, dtype), None, 10.0)
            (g,) = torch.autograd.grad(w0 + w1 + s0 + s1, x)
        return g.double().cpu(), acts

    mats = [resize_weights(256, SIMPLE_SIZE, "bilinear", device=d).cpu() for d in ("cpu", "cuda")]
    out = {("matrix", "card entries off the CPU's"): int((mats[0] != mats[1]).sum())}
    for part, x in (("a", img), ("b", small)):
        ref, ref_acts = grad(x, "cpu", torch.float64, True)
        gs = {}
        for run, device, cudnn in (("cpu", "cpu", True), ("cuDNN off", "cuda", False),
                                   ("cuDNN on", "cuda", True)):
            g, acts = gs[run] = grad(x, device, torch.float32, cudnn)
            out[part, run] = ((g - ref).norm() / ref.norm()).item()
            if part == "b":
                out[part, f"{run} ReLU flips"] = sum(int(((a > 0) != (r > 0)).sum())
                                                     for a, r in zip(acts, ref_acts))
        # the median element's error, robust to a few flipped ReLUs (each
        # moves the gradient in one receptive field); the controls: the
        # card's cuDNN-off gradient off by 1 + delta, what a fault reads
        cpu = (gs["cpu"][0] - ref).abs().median().item()
        for run in ("cuDNN off", "cuDNN on"):
            out[part, f"{run} median element error / the CPU's"] = (
                (gs[run][0] - ref).abs().median().item() / cpu)
        for d in CONTROL_DELTAS:
            out[part, f"control x (1 + {d:g}) median element error / the CPU's"] = (
                (gs["cuDNN off"][0] * (1 + d) - ref).abs().median().item() / cpu)
    return out


# -- the EVAL switches: blurred-LR inputs, weight maps, stage 1 ---------------------

# each variant's launches a forward (tgsr_tpu_torch/engine/inference.py): the
# x8 map and blur paths launch what the main path does (the blur and the maps
# are plain tensor ops, the 256 px site blends its map in the kernel); stage 1
# attends once and has no up-head site in its low branch
VARIANT_PER_FORWARD = {
    "x8": {"float32": {"word_pixel_attention": 3, "up_head": 2},
           "bfloat16": {"word_pixel_attention": 3, "up_head_packed": 2},
           "int8": {"word_pixel_attention": 3, "int8_conv": 42, "glu_requant_one": 6,
                    "glu_requant_pair": 10, "requant": 26}},
    "stage1": {"float32": {"word_pixel_attention": 1, "up_head": 1},
               "bfloat16": {"word_pixel_attention": 1, "up_head_packed": 1},
               "int8": {"word_pixel_attention": 1, "int8_conv": 40, "glu_requant_one": 2,
                        "glu_requant_pair": 9, "requant": 29}},
}
VARIANTS = (  # (name, EVAL fields, per-forward table, paths)
    ("x8 lr-lrblur map", {"INPUT_NETGH": "lr-lrblur", "WEIGHTMAP": True}, "x8",
     ("float32", "bfloat16", "int8")),
    ("x8 lrblur", {"INPUT_NETGH": "lrblur"}, "x8", ("float32",)),
    ("x8 stage1", {"STAGE1": True}, "stage1", ("float32", "bfloat16", "int8")),
)
VARIANT_B = 64
VARIANT_TRAIN_B = 16
VARIANT_CPU_SEED = 181  # the stream of the weight-map step's CPU batch
# the 256 px site of the weight-map path: upscale8x + conv_output + a3 * srb
MAP_SITE = (32, 64, 5, True, True, "upscale8x+conv_output+a3*srb")


def weight_map_kernel_rows(torch, h=128):
    """Rows 2 and 3 at the 256 px site of the x8 weight-map path (B = 64,
    `MAP_SITE`), blending a per-pixel map a3 = 1 + U(-0.5, 0.5) [2H, 2W] read
    by each output pixel, against their plain versions at the gates of
    `up_head_phase` (row 2 and row 3 float32 1e-4, row 3 bfloat16 2e-2 of
    max(1, |ref|max)); a map of one value gives the scalar's bits; each
    timed with the map and with the scalar (CUDA events and `device_ms`).
    Returns {"up_head": {...}, "up_head_packed": {...}}: the map instance's
    numbers, its `scalar_ms` beside them."""
    from tgsr_tpu_torch.ops.packed_tail import packed_up_head
    from tgsr_tpu_torch.ops.up_head import (fold_bn, prepare_up_head, reference_up_head,
                                            up_head_folded)
    from tgsr_tpu_torch.ops.up_head_packed import fused_up_head_packed, prepare_up_head_packed

    cin, c2, k, use_tanh, blend, site = MAP_SITE
    w = h
    x = torch.randn(B, h, w, cin, device="cuda")
    w_up = torch.randn(3, 3, cin, c2, device="cuda") / (9 * cin) ** 0.5
    mul, add = fold_bn(1 + 0.1 * torch.randn(c2, device="cuda"), 0.1 * torch.randn(c2, device="cuda"),
                       0.2 * torch.randn(c2, device="cuda"), 0.5 + 1.5 * torch.rand(c2, device="cuda"))
    w_head = torch.randn(k, k, c2 // 2, 3, device="cuda") / (k * k * c2 / 2) ** 0.5
    srb = torch.rand(B, 2 * h, 2 * w, 3, device="cuda") * 2 - 1
    amap = 1 + torch.rand(2 * h, 2 * w, device="cuda") - 0.5
    scalar = torch.tensor(0.75, device="cuda")
    kw = dict(use_tanh=use_tanh, blend=blend)
    n_out = B * 4 * h * w
    up_flops = n_out * 2 * 4 * cin * c2
    rest_flops = n_out * (2 * k * k * (c2 // 2) * 3 + 8 * c2) + 2 * n_out * 3
    rows = {}
    # row 2, float32
    wts = prepare_up_head(w_up, mul, add, w_head)
    ref = reference_up_head(x, w_up, mul, add, w_head, srb, amap, **kw)
    got = up_head_folded(wts, x, srb, amap, **kw)
    const = up_head_folded(wts, x, srb, torch.full_like(amap, 0.75), **kw)
    sc = up_head_folded(wts, x, srb, scalar, **kw)
    torch.cuda.synchronize()
    err, top = (got - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 1e-4 * max(1.0, top), f"up-head kernel with a weight map == plain at {site} "
                                       f"[{B},{h},{w},{cin}] (max abs err {err:.3e})")
    check(torch.equal(const, sc), "up-head kernel: a map of one value gives the scalar's bits")
    nbytes = 4 * (x.numel() + w_up.numel() + w_head.numel() + 2 * c2 + 3 * n_out * 2 + amap.numel())
    t_ops = 3 * up_flops / TF32_FLOP_PER_S + rest_flops / F32_FLOP_PER_S
    bms = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
    run = lambda a: lambda: up_head_folded(wts, x, srb, a, **kw)  # noqa: E731
    rows["up_head"] = dict(
        ms=cuda_ms_median(run(amap), iters=5), device_ms=device_ms(torch, run(amap)),
        scalar_ms=cuda_ms_median(run(scalar), iters=5),
        scalar_device_ms=device_ms(torch, run(scalar)),
        plain_ms=cuda_ms(lambda: reference_up_head(x, w_up, mul, add, w_head, srb, amap, **kw),
                         iters=5),
        bound_ms=bms, bound_by="bytes" if nbytes / HBM_BYTES_PER_S * 1e3 >= bms else "operations",
        max_abs_err=err, library_ms=None,
        shapes=f"B {B}, {h}->{2 * h} px, {site}, float32; a3 [{2 * h}, {2 * w}]; ms and "
               f"scalar_ms by CUDA events (median of five 5-call means), device_ms with the "
               f"host's launches queued behind a spin kernel")
    # row 3, float32 (CUDA cores) and bfloat16 (tensor cores)
    row3 = {}
    for dtype, esize, rate, gate in ((torch.float32, 4, F32_FLOP_PER_S, 1e-4),
                                     (torch.bfloat16, 2, BF16_FLOP_PER_S, 2e-2)):
        tag = str(dtype).split(".")[-1]
        pw = prepare_up_head_packed(w_up, mul, add, w_head, dtype=dtype)
        xs, ss, am = x.to(dtype), srb.to(dtype), amap.to(dtype)
        ref3 = packed_up_head(xs, pw, ss, am, **kw)
        got3 = fused_up_head_packed(xs, pw, ss, am, **kw)
        c3 = fused_up_head_packed(xs, pw, ss, torch.full_like(am, 0.75), **kw)
        s3 = fused_up_head_packed(xs, pw, ss, scalar.to(dtype), **kw)
        torch.cuda.synchronize()
        err3, top3 = (got3 - ref3).abs().max().item(), ref3.abs().max().item()
        check(err3 <= gate * max(1.0, top3), f"packed up-head kernel {tag} with a weight map == "
                                             f"plain at {site} (max abs err {err3:.3e})")
        check(torch.equal(c3, s3), f"packed up-head kernel {tag}: a map of one value gives the "
                                   f"scalar's bits")
        nb3 = (esize * (x.numel() + pw.w_up.numel() + pw.w_head.numel() + 3 * n_out + amap.numel())
               + 4 * (2 * c2 + 3 * n_out))
        bms3, by3 = bound_ms(nb3, up_flops + rest_flops, rate)
        run3 = lambda a: lambda: fused_up_head_packed(xs, pw, ss, a, **kw)  # noqa: E731
        row3[dtype] = dict(
            ms=cuda_ms_median(run3(am), iters=5), device_ms=device_ms(torch, run3(am)),
            scalar_ms=cuda_ms_median(run3(scalar.to(dtype)), iters=5),
            scalar_device_ms=device_ms(torch, run3(scalar.to(dtype))),
            plain_ms=cuda_ms(lambda: packed_up_head(xs, pw, ss, am, **kw), iters=5),
            bound_ms=bms3, bound_by=by3, max_abs_err=err3, library_ms=None)
    rows["up_head_packed"] = {
        **row3[torch.bfloat16], "float32": row3[torch.float32],
        "shapes": rows["up_head"]["shapes"].replace(
            "float32;", "bfloat16 (top level; 'float32' the f32 instance);")}
    for name, r in rows.items():
        print(f"  {name} with a weight map at {site}: {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}), scalar {r['scalar_ms']:.4f} ms (device "
              f"{r['scalar_device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err {r['max_abs_err']:.3e}",
              flush=True)
    return rows


def library_modules_on_card(torch):
    """The HF branch's library modules (no entry point builds them), one
    float32 forward each at full width (GF_DIM 32, B = 2, seeded weights)
    on the card against the CPU: max abs error <= 1e-3 (TF32 off)."""
    from tgsr_tpu_torch.checkpoints.from_jax import _seed_module
    from tgsr_tpu_torch.models.generator_hf import NetGHigh, NetGHighSRWeight, lr_blur
    from tgsr_tpu_torch.models.models16 import NetGHigh16, NetGHighWeight16

    gen = torch.Generator().manual_seed(18)
    x8, x16 = (32, (64, 128, 256)), (32, (64, 128, 256, 512))
    cases = (("NetGHigh", NetGHigh(32), x8, {"low": True}),
             ("NetGHigh cat", NetGHigh(32, cat=True), x8, {}),
             ("NetGHighSRWeight", NetGHighSRWeight(32, size=256), (32, (256,)), None),
             ("NetGHigh16", NetGHigh16(32), x16, {"low": False}),
             ("NetGHighWeight16 fix_bugs", NetGHighWeight16(32, low="lr-lrblur", weightmap=True,
                                                            fix_bugs=True), x16, None))
    for name, m, (s, sizes), kw in cases:
        _seed_module(m, gen)
        m.eval().requires_grad_(False)
        lr = torch.rand(2, 3, s, s, generator=gen) * 2 - 1
        srb = [torch.rand(2, 3, z, z, generator=gen) * 2 - 1 for z in sizes]
        args = (lr, srb) + ((lr_blur(lr),) if kw is not None else ())
        with torch.no_grad():
            ref = m(*args, **(kw or {}))
            ref = ref[0] if name == "NetGHighSRWeight" else ref
            mc = m.cuda()
            got = mc(*(a.cuda() if torch.is_tensor(a) else [t.cuda() for t in a] for a in args),
                     **(kw or {}))
            got = got[0] if name == "NetGHighSRWeight" else got
        err = max((g.cpu() - r).abs().max().item() for g, r in zip(got, ref))
        check(len(got) == len(sizes) and err <= 1e-3,
              f"library {name}: one forward on the card == the CPU's (max abs err {err:.3e} "
              f"<= 1e-3, {len(got)} scales)")


def variants_train_inputs(torch):
    """eval_variants_phase's (5) weight-map training config and seeded text
    encoder."""
    import dataclasses

    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.config import EvalConfig, face_s8_config

    tcfg = dataclasses.replace(face_s8_config(), EVAL=dataclasses.replace(
        EvalConfig(), INPUT_NETGH="lr-lrblur", WEIGHTMAP=True))
    return tcfg, seeded_text_state_dict(tcfg, 41, torch.Generator().manual_seed(20))


def eval_variants_phase(torch, rng, card, tmp, cpu_batch, cpu_runs):
    """The EVAL switches on the card (face S8 full width, seeded weights;
    weight maps a1..a3 (x16 a1..a4) drawn 1 + U(-0.5, 0.5)):
    (1) x8 'lr-lrblur' with weight maps in float32, bfloat16 and int8 (scales
    from calibrate_quant on this pipeline), 'lrblur' in float32, and STAGE1 in
    the three paths, one eager forward at B = 64 each against the same
    pipeline on the CPU (float32 max abs error <= 1e-3 and uint8 within 1;
    bfloat16 >= 40 dB against the CPU's float32 at B = 64; int8 >= 40 dB
    against the CPU's int8 on the first 8 images), its launches as the path
    states them (VARIANT_PER_FORWARD), the replay at B = 64 bit for bit the
    eager forward, with the path's launches, and a profile of it; (2) x16 bfloat16 with 'lr-lrblur' and weight maps at B = 8
    against the CPU's float32 (>= 40 dB), 4 attention and 2 packed up-head
    launches; (3) rows 2 and 3 with a map against their plain versions, timed
    with the map and the scalar (`weight_map_kernel_rows`); (4) the x8
    weight-map program exported (bfloat16, symbolic batch) and loaded, bit
    for bit the live pipeline at B = 1 and 64; (5) GAN training with
    'lr-lrblur' and weight maps: the x8 step at B = 4 (`cpu_batch`, from a
    stream of its own) held by `step_against_cpu` against the CPU steps
    `cpu_runs` made beside x16_train_phase's plans, steps at B = 16 in float32 and bfloat16 (finite,
    bfloat16's first-step metrics within 15 % of float32's, 3 attention
    forward and backward launches a step, the step's ms), an x16 bfloat16
    step at B = 4, a
    snapshot round trip (a1..a3 written, no `a`, served equal to the run's
    EMA generator); (6) the library modules (`library_modules_on_card`).
    Returns (the launches of each run, the weight-map kernel rows)."""
    import dataclasses

    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, seeded_text_state_dict
    from tgsr_tpu_torch.checkpoints.io import save_variables
    from tgsr_tpu_torch.checkpoints.msgpack_io import load_variables
    from tgsr_tpu_torch.config import EvalConfig, config_from_file, face_s8_config
    from tgsr_tpu_torch.engine import aot
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.ops import _build

    vocab = 41
    zero = {name: 0 for name in _build.LAUNCH_NAMES}
    launches = {}

    def variant(cfg, **ev):
        return dataclasses.replace(cfg, EVAL=dataclasses.replace(EvalConfig(), **ev))

    def batch(n):
        lr = rng.integers(0, 256, (n, 32, 32, 3)).astype("uint8")
        lens = rng.integers(1, T + 1, n)
        lens[min(1, n - 1)] = 0  # an empty caption
        cap = rng.integers(1, vocab, (n, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        return lr, cap, lens

    lr8, cap8, lens8 = batch(8)
    lr8f = lr8.astype("float32") / 127.5 - 1.0
    lr, cap, lens = batch(VARIANT_B)
    lrf = lr.astype("float32") / 127.5 - 1.0
    lrc, capc, lensc = batch(16)
    lr_d, cap_d, lens_d = (torch.as_tensor(v, device="cuda") for v in (lr, cap, lens))
    live_map = None
    # -- (1) the x8 variants ---------------------------------------------------------
    for name, ev, table, paths in VARIANTS:
        cfg = variant(face_s8_config(), **ev)
        sds = init_seeded(cfg, vocab, torch.Generator().manual_seed(18))
        t0 = time.perf_counter()
        ref = SRPipeline(cfg, vocab, *sds, device="cpu")(lrf, cap, lens)["sr"]
        print(f"  {name}: plain reference on the CPU, B={VARIANT_B}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        scales = None
        for path in paths:
            tag = f"{name} {path}"
            per_forward = dict(zero, **VARIANT_PER_FORWARD[table][path])
            kw = dict(compute_dtype=torch.float32 if path == "float32" else torch.bfloat16)
            if path == "int8":
                kw["quant_scales"] = scales
            kern = SRPipeline(cfg, vocab, *sds, device="cuda", **kw)
            _build.reset_launches()
            got = kern(lrf, cap, lens)["sr"]
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            check(counts == per_forward, f"{tag}: one forward launches {per_forward} ({counts})")
            check(tuple(got.shape) == (VARIANT_B, 256, 256, 3) and bool(torch.isfinite(got).all())
                  and float(got.std()) > 1e-3, f"{tag}: SR finite, not constant, "
                                               f"{tuple(got.shape)}")
            du8 = (to_uint8(got).cpu().int() - to_uint8(ref).int()).abs().max().item()
            if path == "float32":
                err = (got.cpu() - ref).abs().max().item()
                check(err <= 1e-3 and du8 <= 1, f"{tag}: the card's SR == the CPU's (max abs "
                                                f"err {err:.3e} <= 1e-3, uint8 {du8} <= 1)")
            elif path == "bfloat16":
                psnr = psnr_u8(got, ref)
                check(psnr >= 40, f"{tag}: uint8 SR on the card vs float32 on the CPU: PSNR "
                                  f"{psnr:.2f} dB >= 40")
                t0 = time.perf_counter()
                scales = kern.calibrate_quant(lrc.astype("float32") / 127.5 - 1.0, capc, lensc)
                print(f"  {tag}: calibrate_quant on the card, B=16: "
                      f"{time.perf_counter() - t0:.1f} s, {sum(map(len, scales.values()))} scales",
                      flush=True)
                if name.endswith("map"):
                    live_map = kern
            else:
                cref = SRPipeline(cfg, vocab, *sds, device="cpu", **kw)(
                    lrf[:8], cap[:8], lens[:8])["sr"]
                psnr = psnr_u8(got[:8], cref)
                check(psnr >= 40, f"{tag}: uint8 SR on the card vs the same int8 pipeline on "
                                  f"the CPU: PSNR {psnr:.2f} dB >= 40 (vs float32 on the CPU "
                                  f"{psnr_u8(got, ref):.2f} dB)")
            # the replay at B = 64 against the eager forward, with the path's launches
            with torch.inference_mode():
                eager = kern._serve(lr_d, cap_d, lens_d)
            kern.forward_scan(lr[None], cap[None], lens[None])  # captures the graph
            torch.cuda.synchronize()
            _build.reset_launches()
            replay = kern.forward_scan(lr[None], cap[None], lens[None])[0]
            torch.cuda.synchronize()
            launches[f"variants {tag}"] = run = {k: _build.LAUNCHES[k] + _build.REPLAYED[k]
                                                for k in zero}
            check(torch.equal(replay, eager) and run == per_forward,
                  f"{tag}: the replay at B = {VARIANT_B} == the eager forward bit for bit, "
                  f"launches {run}")
            profile_forward(torch, lambda: kern.forward_scan(lr[None], cap[None], lens[None]),
                            tag, "replay", VARIANT_B)
            if kern is not live_map:
                del kern
        gc.collect()
        torch.cuda.empty_cache()

    # -- (2) x16 bfloat16 with the blur and weight maps --------------------------------
    cfg16 = variant(config_from_file(os.path.join(HERE, "configs", "eval_faceSR_S16.yml")),
                    INPUT_NETGH="lr-lrblur", WEIGHTMAP=True)
    sds16 = init_seeded(cfg16, vocab, torch.Generator().manual_seed(19))
    ref16 = SRPipeline(cfg16, vocab, *sds16, device="cpu")(lr8f, cap8, lens8)["sr"]
    kern16 = SRPipeline(cfg16, vocab, *sds16, compute_dtype=torch.bfloat16)
    _build.reset_launches()
    got16 = kern16(lr8f, cap8, lens8)["sr"]
    torch.cuda.synchronize()
    launches["variants x16 lr-lrblur map bfloat16"] = run = dict(_build.LAUNCHES)
    want = dict(zero, word_pixel_attention=4, up_head_packed=2)
    psnr = psnr_u8(got16, ref16)
    check(run == want and tuple(got16.shape) == (8, 512, 512, 3) and psnr >= 40,
          f"x16 lr-lrblur map bfloat16, B = 8: launches {run}, uint8 SR vs float32 on the CPU "
          f"PSNR {psnr:.2f} dB >= 40")
    del kern16
    gc.collect()

    # -- (3) rows 2 and 3 with a map ---------------------------------------------------------
    rows = weight_map_kernel_rows(torch)

    # -- (4) the exported weight-map program --------------------------------------------------
    t0 = time.perf_counter()
    art = aot.AOTPipeline(aot.export_serving(live_map, os.path.join(tmp, "aot_map")))
    t_export = time.perf_counter() - t0
    _build.reset_launches()
    outs = {1: art.sr_uint8(lr8f[:1], cap8[:1], lens8[:1]),
            VARIANT_B: art.sr_uint8(lrf, cap, lens)}
    torch.cuda.synchronize()
    launches["variants aot map bfloat16"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k]
                                             for k in zero}
    refs = {1: live_map.sr_uint8(lr8f[:1], cap8[:1], lens8[:1]),
            VARIANT_B: live_map.sr_uint8(lrf, cap, lens)}
    same = {b: bool(np.array_equal(outs[b], refs[b])) for b in outs}
    check(all(same.values()), f"aot x8 lr-lrblur map bfloat16: the exported program's SR == "
                              f"the live pipeline's at B = 1, {VARIANT_B} ({same}); export and "
                              f"load {t_export:.2f} s")
    del art, live_map
    gc.collect()
    torch.cuda.empty_cache()

    # -- (5) GAN training with the blur and weight maps -------------------------------------
    # the CPU steps on `cpu_batch` were made beside x16_train_phase's plans
    tcfg, text_sd = variants_train_inputs(torch)
    step_against_cpu(torch, tcfg, text_sd, cpu_batch, cpu_runs=cpu_runs)
    first = {}
    tb = [train_batch(torch, rng, VARIANT_TRAIN_B) for _ in range(3)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "variants train map " + str(dtype).split(".")[-1]
        t = GANTrainer(tcfg, vocab, text_sd, compute_dtype=dtype)
        s = t.init_state(torch.Generator().manual_seed(0))
        _build.reset_launches()
        ms, times = [], []
        for b in tb:
            t0 = time.perf_counter()
            ms.append(t.train_step(s, b))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = [{k: float(v) for k, v in m.items()} for m in ms]
        launches[tag] = run = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in zero}
        first[dtype] = ms[0]
        check(s.a is None and all(np.isfinite(v) for m in ms for v in m.values())
              and run["word_pixel_attention"] == run["word_pixel_attention_bwd"] == 9,
              f"{tag}: 3 steps at B = {VARIANT_TRAIN_B}, finite, no trained a, 3 attention "
              f"forward and backward launches a step ({run['word_pixel_attention']}, "
              f"{run['word_pixel_attention_bwd']})")
        print(f"  {tag}: step {1e3 * float(np.mean(times[1:])):.2f} ms at B = {VARIANT_TRAIN_B} "
              f"(host clock, synchronised, mean of steps 2-3; first {1e3 * times[0]:.1f}) on "
              f"{card}", flush=True)
        if dtype == torch.float32:
            snap = os.path.join(tmp, "Model")
            os.makedirs(snap, exist_ok=True)
            netg_v, netgh_v = s.snapshot_variables()
            save_variables(os.path.join(snap, "netG_it2.msgpack"), netg_v)
            save_variables(os.path.join(snap, "netGH_it2.msgpack"), netgh_v)
            back = load_variables(os.path.join(snap, "netGH_it2.msgpack"))["params"]
            te = os.path.join(tmp, "variants_text_encoder.pth")
            torch.save(text_sd, te)
            pipe = SRPipeline.from_reference_checkpoints(
                tcfg, vocab, os.path.join(snap, "netG_it2.msgpack"), text_encoder_path=te)
            bb = train_batch(torch, rng, 4)
            served = pipe(bb["lr"].cpu().numpy(), bb["captions"].cpu().numpy(),
                          bb["cap_lens"].cpu().numpy())["sr"]
            err = (served.to("cuda") - t.super_resolve(s, bb)).abs().max().item()
            check({"a1", "a2", "a3"} <= set(back) and "a" not in back and err <= 1e-3,
                  f"train map snapshot: a1..a3 written, no a; served by SRPipeline == the EMA "
                  f"generator (max abs err {err:.3e} <= 1e-3)")
            del pipe
        del t, s
        gc.collect()
        torch.cuda.empty_cache()
    worst = max(abs(first[torch.bfloat16][k] - v) / abs(v)
                for k, v in first[torch.float32].items() if abs(v) > 1e-3)
    check(worst < 0.15, f"train map bf16 first-step metrics within 15 % of f32's "
                        f"(worst {worst:.3%})")
    c16 = variant(x16_train_config(), INPUT_NETGH="lr-lrblur", WEIGHTMAP=True)
    t = GANTrainer(c16, vocab, seeded_text_state_dict(c16, vocab, torch.Generator().manual_seed(21)),
                   compute_dtype=torch.bfloat16)
    s = t.init_state(torch.Generator().manual_seed(0))
    _build.reset_launches()
    m = {k: float(v) for k, v in t.train_step(s, train_batch(torch, rng, 4, sizes=X16_SIZES)).items()}
    torch.cuda.synchronize()
    launches["variants train x16 map bfloat16"] = run = {k: _build.LAUNCHES[k] for k in zero}
    check(all(np.isfinite(v) for v in m.values()) and "a4" in dict(s.netgh.named_parameters())
          and run["word_pixel_attention"] == run["word_pixel_attention_bwd"] == 4,
          f"train x16 lr-lrblur map bfloat16: a step at B = 4, finite, a1..a4 trained, 4 "
          f"attention forward and backward launches ({run})")
    del t, s
    gc.collect()
    torch.cuda.empty_cache()

    # -- (6) the library modules ------------------------------------------------------------
    library_modules_on_card(torch)
    return launches, rows


def gru_phase(torch, rng, card, tmp):
    """RNN_TYPE 'GRU' through the serving, export and training entry points
    (face S8 at full width: EMBEDDING_DIM 256, T 18, seeded weights). Per
    path (float32, bfloat16, int8 with scales from calibrate_quant on the
    card): one eager forward at B = 8 with the LSTM path's launches (3
    attention; 2 up_head / up_head_packed; int8 3 / 42 / 6 / 10 / 26) against
    the same pipeline on the CPU (float32 max abs error <= 1e-3; bfloat16 >=
    40 dB against the CPU's float32; int8 >= 40 dB against the CPU's int8 on
    4 images and >= INT8_PSNR_FLOOR against float32), then sr_batched at
    B = 64 (a graph replay) bit for bit the eager __call__. The bfloat16
    pipeline exported (symbolic batch) and loaded as an AOTPipeline, bit for
    bit the live one at B = 1 and 3. The GRU text encoder's device ms at
    B = 64 beside the LSTM's. One float32 GAN step (D frozen) and one DAMSM
    step (Inception) with a GRU text encoder against the CPU, by
    `step_against_cpu` and `damsm_step_against_cpu`. Returns the launches of
    each path's runs."""
    import dataclasses

    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, seeded_text_state_dict
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine import aot
    from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
    from tgsr_tpu_torch.models.text_encoder import TextEncoder
    from tgsr_tpu_torch.ops import _build

    cfg = dataclasses.replace(face_s8_config(), RNN_TYPE="GRU")
    vocab = 41
    sds = init_seeded(cfg, vocab, torch.Generator().manual_seed(19))
    check(tuple(sds[0]["rnn.weight_hh_l0"].shape) == (3 * 128, 128),
          "gru: the seeded text encoder holds a GRU's [3H, H] recurrent weights")
    zero = {name: 0 for name in _build.LAUNCH_NAMES}

    def batch(n):
        lr = rng.integers(0, 256, (n, 32, 32, 3)).astype("uint8")
        lens = rng.integers(1, T + 1, n)
        lens[min(1, n - 1)] = 0  # an empty caption
        cap = rng.integers(1, vocab, (n, T))
        cap[np.arange(T)[None, :] >= lens[:, None]] = 0
        return lr, cap, lens

    lr8, cap8, lens8 = batch(8)
    lr8f = lr8.astype("float32") / 127.5 - 1.0
    step_batch = train_batch(torch, rng, 4, device="cpu")
    ref = SRPipeline(cfg, vocab, *sds, device="cpu")(lr8f, cap8, lens8)["sr"]
    lr64, cap64, lens64 = batch(64)
    lrc, capc, lensc = batch(16)
    launches, scales = {}, None
    for tag in ("float32", "bfloat16", "int8"):
        per_forward = dict(zero, **PATH_KERNELS[tag])
        kw = dict(compute_dtype=torch.float32 if tag == "float32" else torch.bfloat16)
        if tag == "int8":
            kw["quant_scales"] = scales
        kern = SRPipeline(cfg, vocab, *sds, device="cuda", **kw)
        _build.reset_launches()
        got = kern(lr8f, cap8, lens8)["sr"]
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        check(counts == per_forward and kern.text_encoder.rnn_type == "GRU",
              f"gru {tag}: one forward launches the LSTM path's {PATH_KERNELS[tag]} ({counts})")
        check(tuple(got.shape) == (8, 256, 256, 3) and bool(torch.isfinite(got).all())
              and float(got.std()) > 1e-3, f"gru {tag}: SR finite, not constant, "
                                           f"{tuple(got.shape)}")
        if tag == "float32":
            err = (got.cpu() - ref).abs().max().item()
            check(err <= 1e-3, f"gru float32: SR on the card == the CPU's (max abs err "
                               f"{err:.3e} <= 1e-3)")
        elif tag == "bfloat16":
            psnr = psnr_u8(got, ref)
            check(psnr >= 40, f"gru bfloat16 on the card vs float32 on the CPU: PSNR "
                              f"{psnr:.2f} dB >= 40")
        else:
            cref = SRPipeline(cfg, vocab, *sds, device="cpu", **kw)(
                lr8f[:4], cap8[:4], lens8[:4])["sr"]
            psnr_cpu, psnr = psnr_u8(got[:4], cref), psnr_u8(got, ref)
            check(psnr_cpu >= 40 and psnr >= INT8_PSNR_FLOOR,
                  f"gru int8 on the card vs int8 on the CPU (same scales): PSNR {psnr_cpu:.2f} "
                  f"dB >= 40; vs float32 on the CPU {psnr:.2f} dB >= {INT8_PSNR_FLOOR}")
        kern.sr_batched(lr64, cap64, lens64, microbatch=64)  # captures
        _build.reset_launches()
        out = kern.sr_batched(lr64, cap64, lens64, microbatch=64)
        torch.cuda.synchronize()
        check(_build.LAUNCHES == zero and _build.REPLAYED == per_forward,
              f"gru {tag}: one replay at B = 64 launched the captured counts "
              f"({_build.REPLAYED}) and nothing eagerly")
        launches[f"gru {tag}"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k] for k in zero}
        with torch.inference_mode():
            lr_f = torch.as_tensor(lr64, device="cuda").float() / 127.5 - 1.0
            eager = to_uint8(kern(lr_f, cap64, lens64)["sr"]).cpu().numpy()
        check(np.array_equal(out, eager), f"gru {tag}: sr_batched at B = 64 (replay) == the "
                                          f"eager __call__, bit for bit "
                                          f"({int((out != eager).sum())} values differ)")
        if tag == "bfloat16":
            scales = kern.calibrate_quant(lrc.astype("float32") / 127.5 - 1.0, capc, lensc)
            t0 = time.perf_counter()
            art = aot.AOTPipeline(aot.export_serving(kern, os.path.join(tmp, "aot_gru")))
            t_export = time.perf_counter() - t0
            lr3 = lr64[:3].astype("float32") / 127.5 - 1.0
            _build.reset_launches()
            got_art = {b: art.sr_uint8(lr3[:b], cap64[:b], lens64[:b]) for b in (1, 3)}
            torch.cuda.synchronize()
            replayed = dict(_build.REPLAYED)
            launches["gru aot"] = {k: _build.LAUNCHES[k] + replayed[k] for k in zero}
            same = {b: bool(np.array_equal(g, kern.sr_uint8(lr3[:b], cap64[:b], lens64[:b])))
                    for b, g in got_art.items()}
            check(all(same.values()) and replayed == {k: 2 * v for k, v in per_forward.items()},
                  f"gru aot bfloat16: the exported GRU program == the live pipeline bit for "
                  f"bit at B = 1, 3 ({same}; export and load {t_export:.1f} s, replayed "
                  f"{replayed})")
            del art
        del kern
        gc.collect()
        torch.cuda.empty_cache()

    # the text encoder alone at B = 64, GRU beside LSTM
    capd = torch.as_tensor(cap64, device="cuda")
    lensd = torch.as_tensor(lens64, device="cuda")
    times = {}
    for rnn in ("LSTM", "GRU"):
        c = dataclasses.replace(cfg, RNN_TYPE=rnn)
        te = TextEncoder(vocab, 300, 256, rnn_type=rnn)
        te.load_state_dict(seeded_text_state_dict(c, vocab, torch.Generator().manual_seed(20)))
        te = te.cuda().eval().requires_grad_(False)
        with torch.inference_mode():
            eager = cuda_ms_median(lambda: te(capd, lensd), repeats=3, iters=10)
            # its device time: the same forward captured and replayed, the
            # host's launch gaps gone (2 x 18 steps of small kernels)
            te(capd, lensd)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                te(capd, lensd)
            times[rnn] = (eager, cuda_ms_median(graph.replay, repeats=3, iters=10))
            del graph
    for rnn, (ms, dms) in times.items():
        print(f"  text encoder {rnn} B=64 T={T}: {ms:.4f} ms eager (events), {dms:.4f} ms "
              f"under graph replay, on {card}", flush=True)
    check(all(np.isfinite(v).all() for v in times.values()),
          f"gru: the text encoders timed ({times})")

    # one GAN step (D frozen: G's step reads the GRU's words) and one DAMSM step
    print("  gru: the GAN step and the DAMSM step below train with a GRU text encoder",
          flush=True)
    # its CPU steps run alone: in a thread beside the CPU references above the
    # CPU float32 step's error (the gate's unit) moved (PERF.md, §7)
    step_against_cpu(torch, cfg, sds[0], step_batch, d_lrs=(0.0,))
    damsm_step_against_cpu(torch, dataclasses.replace(damsm_config(), RNN_TYPE="GRU"),
                           damsm_batch(rng, DAMSM_CPU_B))
    return launches


def _loss_closures(torch, gen, device, sizes, b, e=256, r=289):
    """Small closures for the loss families (the discriminators of `sizes`,
    an image encoder, their weights drawn from `gen` on the CPU) and their
    inputs, on `device`: (ds, image_encoder, fakes, reals, sent, words,
    cap_lens, class_ids, word_scale)."""
    n = lambda *shape: torch.randn(shape, generator=gen)
    d = [{"wf": n(3, 16), "wc": n(16), "ws": n(e) * 0.05, "wu": n(16)} for _ in sizes]
    enc = {"we": n(3, e), "wcode": n(e, e) * 0.05}
    imgs = [[n(b, 3, s, s).clamp(-1, 1) for s in sizes] for _ in range(2)]
    lens = torch.randint(1, T + 1, (b,), generator=gen)
    mv = lambda x: x.to(device)
    d = [{k: mv(v) for k, v in p.items()} for p in d]
    enc = {k: mv(v) for k, v in enc.items()}

    def scale(p):
        return (lambda img: torch.tanh(img.mean(dim=(2, 3)) @ p["wf"]),
                lambda f, sent: f @ p["wc"] + sent @ p["ws"], lambda f: f @ p["wu"])

    def image_encoder(img):
        regions = img.flatten(2).transpose(1, 2)[:, :r] @ enc["we"]
        return regions, regions.mean(dim=1) @ enc["wcode"]

    return ([scale(p) for p in d], image_encoder, [[mv(x) for x in s] for s in imgs],
            mv(n(b, e)), mv(n(b, T, e)), mv(lens), mv(torch.arange(b) % 3),
            mv(torch.rand((b, T), generator=gen) + 0.5))


def library_phase(torch):
    """The library the JAX package exports and no entry point builds, one
    call of each module and loss on the card against the same call on the
    CPU (TF32 off; max abs error <= 1e-3): the blocks DownBlock, Block3x3Relu,
    PlainResidualBlock; WordPixelAttentionWeighted, word_region_attention;
    every module of models/variants.py at GF_DIM 32 and nef 256 (the stages
    that attend, InitStageGImg and NextStageGLR, through row 1's kernel,
    their launches counted under the path "library"); ESRGANDNet (ndf 64,
    128 px); VGG16Features (64 px); orthogonal_reinit (the same draw on the
    card as on the CPU); the loss families of losses/gan.py and
    losses/mani.py on small closures (VGG16Features as the Mani loss's VGG).
    Returns {"library": launches}."""
    import copy

    from tgsr_tpu_torch.checkpoints.from_jax import _seed_module
    from tgsr_tpu_torch.losses import gan as lg
    from tgsr_tpu_torch.losses import mani as lm
    from tgsr_tpu_torch.models import variants as v
    from tgsr_tpu_torch.models.discriminator import ESRGANDNet
    from tgsr_tpu_torch.models.vgg import VGG16Features
    from tgsr_tpu_torch.ops import _build
    from tgsr_tpu_torch.ops import attention as att
    from tgsr_tpu_torch.ops import blocks
    from tgsr_tpu_torch.utils.init import orthogonal_reinit

    gen = torch.Generator().manual_seed(21)
    u = lambda *shape: torch.rand(shape, generator=gen) * 2 - 1
    words = u(2, T, 256)
    mask = torch.arange(T)[None, :] >= torch.tensor([T, 5])[:, None]
    cases = (
        ("DownBlock", blocks.DownBlock(32, 64), (u(2, 32, 64, 64),)),
        ("Block3x3Relu", blocks.Block3x3Relu(64, 32), (u(2, 64, 64, 64),)),
        ("PlainResidualBlock", blocks.PlainResidualBlock(64, use_norm=True),
         (u(2, 64, 64, 64),)),
        ("WordPixelAttentionWeighted", att.WordPixelAttentionWeighted(32, 256),
         (u(2, 32, 64, 64), words, mask)),
        ("InitStageG", v.InitStageG(512, 200), (u(2, 100), u(2, 100))),
        ("InitStageGup4", v.InitStageGup4(512, 200), (u(2, 100), u(2, 100))),
        ("InitStageGim", v.InitStageGim(32, 8, 100), (u(2, 3, 32, 32), u(2, 100))),
        ("InitStageGf", v.InitStageGf(32, 8, 100, 32), (u(2, 32, 32, 32), u(2, 100))),
        ("InitStageGfc", v.InitStageGfc(32, 8, 100), (u(2, 100),)),
        ("InitStageGfc scale 1", v.InitStageGfc(32, 1, 100), (u(2, 100),)),
        ("InitStageGImg", v.InitStageGImg(32, 2, cdf=256), (u(2, 3, 32, 32), words, mask)),
        ("InitStageGImg weightatten", v.InitStageGImg(32, 2, True, cdf=256),
         (u(2, 3, 32, 32), words, mask)),
        ("NextStageGNoAttn", v.NextStageGNoAttn(32, 2, 32), (u(2, 32, 64, 64),)),
        ("NextStageGLR", v.NextStageGLR(32, 2, 256), (u(2, 32, 64, 64), words, mask)),
        ("EDCoder", v.EDCoder(32), (u(2, 3, 64, 64),)),
        ("IAWD", v.IAWD(256, 32), (u(2, 32, 16, 16), words)),
        ("WordAtten", v.WordAtten(256, 32), (u(2, 32, 16, 16), words)),
        ("IAWDSent", v.IAWDSent(32), (u(2, 32, 32, 32), u(2, 256))),
        ("IAWDWord", v.IAWDWord(32), (u(2, 32, 32, 32), u(2, 256, T))),
        ("IAWDSpatial", v.IAWDSpatial(), (u(2, 32, 16, 16), words)),
        ("ESRGANDNet", ESRGANDNet(64), (u(2, 3, 128, 128),)),
        ("VGG16Features", VGG16Features(), (u(2, 3, 64, 64),)),
    )
    zero = {name: 0 for name in _build.LAUNCH_NAMES}
    library = dict(zero)
    for name, m, args in cases:
        _seed_module(m, gen)
        m.eval().requires_grad_(False)
        with torch.no_grad():
            ref = m(*args)
            mc = copy.deepcopy(m).cuda()
            _build.reset_launches()
            got = mc(*(a.cuda() for a in args))
            torch.cuda.synchronize()
            for k in zero:
                library[k] += _build.LAUNCHES[k]
        ref, got = (x if isinstance(x, (tuple, list)) else (x,) for x in (ref, got))
        err = max((g.cpu() - r).abs().max().item() for g, r in zip(got, ref) if r is not None)
        check(err <= 1e-3, f"library {name}: one forward on the card == the CPU's (max abs err "
                           f"{err:.3e} <= 1e-3)")
    check(library["word_pixel_attention"] == 2,
          f"library: InitStageGImg and NextStageGLR went through row 1's kernel, one launch "
          f"each ({library['word_pixel_attention']})")
    regions, w4 = u(2, 289, 256), words
    ctx = [att.word_region_attention(w4.to(dev), regions.to(dev), 4.0, mask.to(dev))[0].cpu()
           for dev in ("cpu", "cuda")]
    err = (ctx[1] - ctx[0]).abs().max().item()
    check(err <= 1e-3, f"library word_region_attention on the card == the CPU's ({err:.3e})")
    m_cpu, m_card = ESRGANDNet(64), ESRGANDNet(64).cuda()
    orthogonal_reinit(m_cpu, torch.Generator().manual_seed(22))
    orthogonal_reinit(m_card, torch.Generator().manual_seed(22))
    err = max((m_card.state_dict()[k].cpu() - x).abs().max().item()
              for k, x in m_cpu.state_dict().items())
    check(err <= 1e-6, f"library orthogonal_reinit on the card == on the CPU ({err:.3e})")

    vgg = VGG16Features()
    _seed_module(vgg, gen)
    vggs = {"cpu": vgg.eval(), "cuda": copy.deepcopy(vgg).cuda().eval()}
    losses = {
        "generator_loss word_scale": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg: lg.generator_loss(
            ds, en, fk, s, w, ln, ci, word_scale=ws),
        "generator_loss_oneim": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.generator_loss_oneim(ds[-1], en, fk, s, w, ln, ci),
        "discriminator_loss_sigmoid": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.discriminator_loss_sigmoid(*ds[-1], rl[-1], fk[-1], s),
        "generator_loss_sigmoid": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.generator_loss_sigmoid(ds, en, fk, s, w, ln, ci),
        "generator_loss_wordsent_only": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.generator_loss_wordsent_only(en, fk, s, w, ln, ci),
        "generator_loss_no_wordsent": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.generator_loss_no_wordsent(ds, fk, s),
        "generator_loss_face": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.generator_loss_face(ds, en, fk, s, w, ln, ci, g=[0.5, 1.5]),
        "generator_loss_uncond": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.generator_loss_uncond(ds, fk),
        "discriminator_loss_uncond": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.discriminator_loss_uncond(ds[0][0], ds[0][2], rl[0], fk[0]),
        "esrgan_g_loss": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.esrgan_g_loss(lambda x: ds[1][2](ds[1][0](x)), fk[1], rl[1]),
        "esrgan_d_loss": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.esrgan_d_loss(lambda x: ds[1][2](ds[1][0](x)), rl[1], fk[1]),
        "relativistic_g_loss": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.relativistic_g_loss(ds[0][0], ds[0][2], fk[0], rl[0]),
        "relativistic_d_loss": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lg.relativistic_d_loss(ds[0][0], ds[0][2], rl[0], fk[0]),
        "word_level_correlation": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lm.word_level_correlation(en(rl[-1])[0], w, ln, (ci > 0).float()),
        "discriminator_loss_mani": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lm.discriminator_loss_mani(*ds[-1], rl[-1], fk[-1], s, en, w, ln),
        "generator_loss_mani": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lm.generator_loss_mani(ds, en, vg, fk, rl, s, w, ln, ci),
        "dcm_generator_loss": lambda ds, en, fk, rl, s, w, ln, ci, ws, vg:
            lm.dcm_generator_loss(*ds[-1], en, fk[-1], s, w, ln, ci),
    }
    for name, fn in losses.items():
        vals = {}
        for dev in ("cpu", "cuda"):
            ds, en, (fk, rl), s, w, ln, ci, ws = _loss_closures(
                torch, torch.Generator().manual_seed(23), dev, (64, 128), 2)
            with torch.no_grad():
                out = fn(ds, en, fk, rl, s, w, ln, ci, ws, vggs[dev])
            out = out if isinstance(out, tuple) else (out, {})
            vals[dev] = {"total": out[0], **out[1]}
        both_nan = all(bool(torch.isnan(x["total"]).all()) for x in vals.values())
        err = 0.0 if both_nan else max(
            (vals["cuda"][k].cpu() - x).abs().max().item() for k, x in vals["cpu"].items())
        check(err <= 1e-3 and sorted(vals["cuda"]) == sorted(vals["cpu"]),
              f"library loss {name} on the card == the CPU's ({len(vals['cpu'])} terms, max "
              f"abs err {err:.3e} <= 1e-3{'; NaN in both, as JAX' if both_nan else ''})")
    return {"library": library}


# -- the input side: JPEG and every PNG form, the host loader, the flower
# and coco example sets through the eval CLI, serve, profile_trace, nan_guard ------

FIXTURES = os.path.join(HERE, "tests", "torch_fixtures")
DATA_IMAGES = 8  # JPEGs in each example set
DATA_WORDS = ("this flower has petals that are red yellow white purple with green stamen "
              "and a bird beak wings brown black dog person table").split()
LOADER_N = 64  # crops of the loader's throughput figure
# the kernel symbol each launch count's wrapper launches, as a trace names it
KERNEL_SYMBOLS = {"word_pixel_attention": "word_pixel_attention_kernel",
                  "up_head": "up_head_kernel", "up_head_packed": "up_head_packed_"}


def jpeg_example_set(rng, root, cfg_path):
    """The example set of the flower / coco eval configs in `root`, built
    from the committed JPEG fixtures: testset.txt (DATA_IMAGES names), one
    caption of one word per <name>.txt, the JPEGs under Img/changetxt_im1,
    and the train split the vocabulary comes from (train/filenames.pickle,
    CAPTIONS_PER_IMAGE captions per text/<name>.txt). Returns the
    vocabulary size."""
    import shutil

    from tgsr_tpu_torch.config import config_from_file
    from tgsr_tpu_torch.data.datasets import TextSRDataset

    jpegs = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    names = [f"example_{i:03d}" for i in range(DATA_IMAGES)]
    per = config_from_file(cfg_path).TEXT.CAPTIONS_PER_IMAGE
    os.makedirs(os.path.join(root, "Img", "changetxt_im1"))
    os.makedirs(os.path.join(root, "text"))
    os.makedirs(os.path.join(root, "train"))
    for i, name in enumerate(names):
        # the 500 x 375 photograph first, then the smaller fixtures
        src = jpegs[(jpegs.index("photo_500x375_420.jpg") + i) % len(jpegs)]
        shutil.copy(os.path.join(FIXTURES, src),
                    os.path.join(root, "Img", "changetxt_im1", name + ".jpg"))
        caps = [str(rng.choice(DATA_WORDS)) for _ in range(per)]  # a word: one map a grid
        with open(os.path.join(root, name + ".txt"), "w") as f:
            f.write(caps[0] + "\n")
        with open(os.path.join(root, "text", name + ".txt"), "w") as f:
            f.write("\n".join(caps) + "\n")
    with open(os.path.join(root, "testset.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "train", "filenames.pickle"), "wb") as f:
        pickle.dump(names, f, protocol=2)
    n_words = TextSRDataset(root, split="train", embeddings_num=per).n_words
    os.remove(os.path.join(root, "captions5450.pickle"))  # the CLI builds its own
    return n_words


def trace_kernels(path: str) -> set:
    """The names of the kernel events in a `profile_trace` file."""
    with open(path) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}


def data_phase(torch, rng, card, tmp):
    """The input side on the card machine. (1) Every committed fixture
    (tests/torch_fixtures: JPEG baseline, progressive, restarts, 4:4:4 to
    4:1:1, grey, CMYK, YCCK; PNG of every colour type and bit depth, Adam7)
    decoded on the host by data/codec.py, bit for bit PIL's committed array.
    (2) `native.load_batch` against stacked `native.load_image` on LOADER_N
    crops of the 500 x 375 JPEG at 256 px (72/64 enlarge), its img/s at 1 and
    8 threads (host clock, warm page cache). (3) `cli.test` on a flower and a
    coco example set of DATA_IMAGES JPEGs (configs/eval_flowerSR_attn2.yml,
    eval_cocoSR_attn2.yml at full width, seeded .pth weights): the bf16
    default and --no-bf16 on the card against --no-bf16 --device cpu (run in a
    thread beside them), f32 within 1 level, bf16 >= 40 dB; rows 1 and 3
    (bf16), 1 and 2 (f32) launched; on the flower set also --int8 (rows 1,
    8, 9, X1, X2; >= 40 dB against the CPU's float32). (4) `cli.serve` on
    the flower weights: a JPEG POSTed in fixed and in native mode answered
    with the bytes the same pixels get as a PNG.
    (5) `profile_trace` around one bf16 and one f32 forward: the trace names
    each hand-written kernel the forward launched. (6) `nan_guard` over one
    f32 training step (D and G) at B = 4 under deterministic algorithms:
    bit for bit the unguarded step; a NaN in one G weight raises. Returns the
    launches of each CLI run."""
    import shutil
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from tgsr_tpu_torch import native
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, seeded_text_state_dict
    from tgsr_tpu_torch.cli import serve
    from tgsr_tpu_torch.cli import test as test_cli
    from tgsr_tpu_torch.config import config_from_file, face_s8_config
    from tgsr_tpu_torch.data import codec
    from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
    from tgsr_tpu_torch.engine.inference import SRPipeline
    from tgsr_tpu_torch.ops import _build
    from tgsr_tpu_torch.utils.observability import FloatCheckError, nan_guard, profile_trace

    # -- (1) the fixtures -------------------------------------------------------------
    t0 = time.perf_counter()
    with np.load(os.path.join(FIXTURES, "pil_rgb.npz")) as z:
        want = {name: z[name] for name in z.files}
    bad = [name for name, arr in want.items()
           if not np.array_equal(codec.load_image_rgb(os.path.join(FIXTURES, name)), arr)]
    check(len(want) >= 28 and not bad,
          f"data: {len(want)} fixtures ({sum(n.endswith('.jpg') for n in want)} JPEG) decode "
          f"bit for bit as PIL's committed arrays on the card's host "
          f"({time.perf_counter() - t0:.2f} s, the JPEG decoder's build included; {bad})")

    # -- (2) the host loader --------------------------------------------------------------
    photo = os.path.join(FIXTURES, "photo_500x375_420.jpg")
    paths = [photo] * LOADER_N
    one = native.load_image(photo, 256, 72 / 64)
    rates = {}
    for threads in (1, 8):
        native.load_batch(paths[:8], 256, 72 / 64, threads)  # warm
        t0 = time.perf_counter()
        got = native.load_batch(paths, 256, 72 / 64, threads)
        rates[threads] = LOADER_N / (time.perf_counter() - t0)
        check(all(np.array_equal(g, one) for g in got),
              f"data: load_batch(threads={threads}) == stacked load_image ({LOADER_N} crops)")
    print(f"  data loader: {LOADER_N} crops of a 500 x 375 JPEG to 256 px: "
          f"{rates[1]:.1f} img/s at 1 thread, {rates[8]:.1f} img/s at 8 threads "
          f"({rates[8] / rates[1]:.2f}x; host clock, {os.cpu_count()} host cores, warm page "
          f"cache) on the host of {card}", flush=True)

    # -- (3) the eval CLI on the flower and coco sets -----------------------------------------
    # the CPU's runs (on a copy of each set: a run writes its caches there) in a
    # thread beside the card's, whose launches they do not touch
    launches, sets = {}, {}
    for dataset in ("flower", "coco"):
        yml = os.path.join(HERE, "configs", f"eval_{dataset}SR_attn2.yml")
        data = os.path.join(tmp, dataset)
        n_words = jpeg_example_set(rng, data, yml)
        shutil.copytree(data, data + "_cpu")
        cfg = config_from_file(yml)
        text_sd, netg_sd, netgh_sd, _ = init_seeded(cfg, n_words,
                                                    torch.Generator().manual_seed(21))
        ckpt = os.path.join(tmp, f"{dataset}_ckpt")
        os.makedirs(ckpt)
        for name, sd in (("netG_epoch_7.pth", netg_sd), ("netGH_epoch_7.pth", netgh_sd),
                         ("text_encoder.pth", text_sd)):
            torch.save(sd, os.path.join(ckpt, name))
        sets[dataset] = dict(cfg=cfg, n_words=n_words, data=data,
                             netg=os.path.join(ckpt, "netG_epoch_7.pth"),
                             te=os.path.join(ckpt, "text_encoder.pth"),
                             base=["--cfg", yml, "--ckpt_dir", ckpt, "--text_encoder",
                                   os.path.join(ckpt, "text_encoder.pth"), "--batch",
                                   str(DATA_IMAGES)])

    def cli_run(dataset, tag, argv):
        t0 = time.perf_counter()
        summary = test_cli.main(sets[dataset]["base"] + argv + ["--out_dir", os.path.join(
            tmp, f"{dataset}_out_{tag.replace(' ', '_')}")])
        if "--device" not in argv:
            torch.cuda.synchronize()
        srs = [codec.load_image_rgb(os.path.join(summary["out_dir"], f"example_{i:03d}_SR.png"))
               for i in range(DATA_IMAGES)]
        return summary, srs, time.perf_counter() - t0

    srs = {}
    with ThreadPoolExecutor(1) as pool:
        cpu = {d: pool.submit(cli_run, d, "cpu float32", ["--no-bf16", "--device", "cpu",
                                                           "--data_dir", sets[d]["data"] + "_cpu"])
               for d in sets}
        for dataset in sets:
            # --int8 (rows 1, 8, 9, X1, X2) on the flower set; the coco run differs in
            # its data alone
            for tag, argv in (("float32", ["--no-bf16"]), ("bf16", []),
                              *((("int8", ["--int8"]),) if dataset == "flower" else ())):
                torch.cuda.synchronize()
                _build.reset_launches()
                summary, srs[dataset, tag], dt = cli_run(
                    dataset, tag, argv + ["--data_dir", sets[dataset]["data"]])
                launches[f"data {dataset} {tag}"] = {k: _build.LAUNCHES[k] + _build.REPLAYED[k]
                                                     for k in _build.LAUNCHES}
                ran = {k: v for k, v in launches[f"data {dataset} {tag}"].items() if v}
                print(f"  data cli {dataset} {tag}: {summary['images']} images, "
                      f"{summary['grids']} grids in {dt:.2f} s (host clock, whole run, the "
                      f"CPU's run beside it); launches {ran} on {card}", flush=True)
                check(summary["images"] == summary["grids"] == DATA_IMAGES and all(
                    x.shape == (256, 256, 3) for x in srs[dataset, tag]),
                    f"data cli {dataset} {tag}: {DATA_IMAGES} JPEGs in, {DATA_IMAGES} 256 px "
                    f"SR PNGs and grids out")
        for dataset in sets:
            summary, srs[dataset, "cpu"], dt = cpu[dataset].result()
            print(f"  data cli {dataset} cpu float32: {summary['images']} images in {dt:.2f} s "
                  f"(host clock, beside the card's runs)", flush=True)
    for dataset in sets:
        worst = max(int(np.abs(a.astype(int) - b).max())
                    for a, b in zip(srs[dataset, "float32"], srs[dataset, "cpu"]))
        check(worst <= 1, f"data cli {dataset} float32: every SR within 1 uint8 level of the "
                          f"CPU's float32 run (max {worst})")
        db = min(10 * np.log10(255.0 ** 2 / max(np.mean((a.astype(float) - b) ** 2), 1e-12))
                 for a, b in zip(srs[dataset, "bf16"], srs[dataset, "cpu"]))
        check(db >= 40, f"data cli {dataset} bf16: every SR >= 40 dB against the CPU's float32 "
                        f"(worst {db:.2f} dB)")
        f32, bf16 = launches[f"data {dataset} float32"], launches[f"data {dataset} bf16"]
        check(f32["word_pixel_attention"] > 0 and f32["up_head"] > 0
              and bf16["word_pixel_attention"] > 0 and bf16["up_head_packed"] > 0,
              f"data cli {dataset}: float32 through rows 1 and 2, bf16 through rows 1 and 3")
    q = {k: v for k, v in launches["data flower int8"].items() if v}
    db = min(10 * np.log10(255.0 ** 2 / max(np.mean((a.astype(float) - b) ** 2), 1e-12))
             for a, b in zip(srs["flower", "int8"], srs["flower", "cpu"]))
    check(db >= 40 and all(k in q for k in ("word_pixel_attention", "int8_conv", "glu_requant_one",
                                            "glu_requant_pair", "requant")),
          f"data cli flower int8: through rows 1, 8, 9, X1 and X2 ({q}), every SR >= 40 dB "
          f"against the CPU's float32 (worst {db:.2f} dB)")
    flower = dict(sets["flower"], vocab_pickle=os.path.join(sets["flower"]["data"],
                                                            "testset.pickle"))

    # -- (4) serve: a JPEG POST in both modes ----------------------------------------------------
    pipe, vocab, args = serve.boot(["--cfg", os.path.join(HERE, "configs",
                                                          "eval_flowerSR_attn2.yml"),
                                    "--netg", flower["netg"], "--text_encoder", flower["te"],
                                    "--vocab_pickle", flower["vocab_pickle"]])
    httpd = serve.make_server(pipe, vocab, port=0, max_batch=1, max_delay_ms=1)
    httpd.batcher.warmup()
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]

    def post(body, query):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/sr{query}", data=body,
                                     headers={"X-Caption": "a red flower"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()

    try:
        for name, query in (("photo_500x375_420.jpg", ""),
                            ("prog_opt_422_61x45.jpg", "?mode=native")):
            with open(os.path.join(FIXTURES, name), "rb") as f:
                body = f.read()
            png = codec.encode_png(want[name])
            (s1, b1), (s2, b2) = post(body, query), post(png, query)
            shape = codec.decode_png(b1).shape if s1 == 200 else None
            check(s1 == s2 == 200 and b1 == b2,
                  f"data serve {query or 'fixed'}: {name} POSTed as JPEG answered with the bytes "
                  f"of the same pixels as PNG (SR {shape})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        server.join(timeout=30)
    del pipe, httpd

    # -- (5) profile_trace around one forward a path ------------------------------------------------
    lr = np.random.default_rng(21).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    caps = np.random.default_rng(21).integers(1, flower["n_words"], (4, T)).astype(np.int64)
    lens = np.full(4, T, np.int64)
    for dtype in (torch.float32, torch.bfloat16):
        p = SRPipeline.from_reference_checkpoints(flower["cfg"], flower["n_words"],
                                                  flower["netg"], text_encoder_path=flower["te"],
                                                  compute_dtype=dtype)
        p(lr, caps, lens)  # warm: the kernels are loaded before the trace
        torch.cuda.synchronize()
        _build.reset_launches()
        with profile_trace(os.path.join(tmp, f"trace_{dtype}")) as path:
            p(lr, caps, lens)
            torch.cuda.synchronize()
        ran = [k for k, v in _build.LAUNCHES.items() if v]
        names = trace_kernels(path)
        missing = [k for k in ran if not any(KERNEL_SYMBOLS.get(k, k) in n for n in names)]
        check(ran and not missing,
              f"data profile_trace {str(dtype).split('.')[-1]}: {os.path.basename(path)} "
              f"({os.path.getsize(path)} bytes, {len(names)} kernel names) names every "
              f"hand-written kernel the forward launched ({ran}; missing {missing})")
        del p

    # -- (6) nan_guard over one f32 training step -------------------------------------------------
    cfg = face_s8_config()
    text_sd = seeded_text_state_dict(cfg, 41, torch.Generator().manual_seed(21))
    batch = train_batch(torch, np.random.default_rng(21), 4)

    def step(guard, poison=False):
        t = GANTrainer(cfg, 41, text_sd)
        s = t.init_state(torch.Generator().manual_seed(0))
        if poison:
            with torch.no_grad():
                s.g_named_parameters()[0][1].view(-1)[0] = float("nan")
        t0 = time.perf_counter()
        m = (nan_guard(t.train_step) if guard else t.train_step)(s, batch)
        torch.cuda.synchronize()
        out = ({k: float(v) for k, v in m.items()}, trainer_readout(torch, s))
        return out, time.perf_counter() - t0

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (plain, dt_plain), (plain2, _), (guarded, dt_guard) = step(False), step(False), step(True)
        raised = ""
        try:
            step(True, poison=True)
        except FloatCheckError as e:
            raised = str(e)
    finally:
        torch.use_deterministic_algorithms(False)
    twice, diff = same_bits(torch, plain, plain2), same_bits(torch, plain, guarded)
    print(f"  data nan_guard: an f32 step at B = 4 {dt_plain * 1e3:.1f} ms unguarded, "
          f"{dt_guard * 1e3:.1f} ms guarded (host clock, first step of a fresh state) on {card}",
          flush=True)
    check(not twice and not diff, f"data nan_guard: the guarded f32 step == the unguarded step "
                                  f"bit for bit (metrics, parameters, Adam moments, BN stats; "
                                  f"two unguarded steps differ in {twice[:3]}, guarded {diff[:3]})")
    check(bool(raised), f"data nan_guard: a NaN in one G weight raises ({raised})")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def step_readings(torch, seeds: list, out_path: str, damsm: bool = False) -> int:
    """`step_against_cpu` on the face S8 batches of `seeds`: per card step,
    the 10th, 50th and 90th percentiles and the largest relative L2 error on
    each batch, and each gradient tensor's largest ratio over them, printed
    (the ten largest) and written to `out_path` as JSON. `damsm`: G's step
    (D frozen) with the DAMSM terms of a SimpleCNNEncoder trained one epoch
    by cli.pretrain_damsm, as damsm_phase makes it, on batches without an
    empty caption; and, per batch, that encoder's backward alone
    (`damsm_input_grads`)."""
    import tempfile

    from tgsr_tpu_torch.checkpoints.from_jax import seeded_text_state_dict
    from tgsr_tpu_torch.config import face_s8_config

    cfg = face_s8_config()
    text_sd = seeded_text_state_dict(cfg, 41, torch.Generator().manual_seed(14))
    kw = {}
    with tempfile.TemporaryDirectory() as tmp:
        if damsm:
            from tgsr_tpu_torch.cli import pretrain_damsm, train_gan

            data, yml, _ = damsm_face_data(np.random.default_rng(0), tmp)
            run = pretrain_damsm.main(["--cfg", yml, "--data_dir", data, "--out_dir",
                                       os.path.join(tmp, "damsm"), "--manualSeed", "5",
                                       "--simple-cnn"])
            enc = train_gan.load_image_encoder_module(
                os.path.join(run["out_dir"], "Model", "image_encoder0.msgpack"), 256)
            control = {f"the terms x (1 + {d:g})": {"damsm": 1 + d} for d in CONTROL_DELTAS}
            kw = {"image_encoder": enc, "d_lrs": (0.0,), "control": control}
        most, stats = {}, {}
        for seed in seeds:
            batch = train_batch(torch, np.random.default_rng(seed), 4, device="cpu",
                                empty=not damsm)
            for key, r in step_against_cpu(torch, cfg, text_sd, batch, **kw).items():
                if isinstance(key[0], str):
                    stats.setdefault(f"D lr {key[1]}, {key[2]}", {}).setdefault(
                        key[0], []).append(r)
                    continue
                got = most.setdefault(f"D lr {key[0]}, {key[1]}", {})
                for name, v in r.items():
                    got[name] = max(v, got.get(name, 0.0))
            if damsm:
                fake = damsm_fake(torch, cfg, text_sd, batch, enc)
                for (part, run), v in damsm_input_grads(torch, enc, text_sd, batch,
                                                        fake).items():
                    stats.setdefault(f"encoder backward ({part})", {}).setdefault(
                        run, []).append(v)
    if not damsm:  # how often the cuDNN-off median gate is exceeded (ROADMAP C 6)
        gate = GRAD_MEDIAN["cuDNN off"]
        for d_lr in ("None", "0.0"):
            meds = stats.get(f"D lr {d_lr}, cuDNN off", {}).get("median", [])
            over = sum(m > gate for m in meds)
            print(f"C 6, D lr {d_lr}: {over} of {len(meds)} seeded batches exceed the cuDNN-off "
                  f"median gate {gate} (medians {', '.join(f'{m:.3g}' for m in meds)})",
                  flush=True)
    for key, vals in stats.items():
        per = "; ".join(f"{q} {', '.join(f'{v:.3g}' for v in vs)}" for q, vs in vals.items())
        top = sorted(most.get(key, {}).items(), key=lambda kv: -kv[1])[:10]
        print(f"{key}: {per}" + (f"; largest over seeds {seeds}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in top) if top else ""), flush=True)
    with open(out_path, "w") as f:
        json.dump({"largest": most, "per batch": stats}, f, indent=1)
    return 1 if FAILURES else 0


def main() -> int:
    sys.path.insert(0, HERE)
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

    if "--step-readings" in sys.argv:
        args = sys.argv[1:]
        seeds = []
        for part in args[args.index("--step-readings") + 1].split(","):
            lo, _, hi = part.partition("-")
            seeds += range(int(lo), int(hi or lo) + 1)
        out = args[args.index("--out") + 1] if "--out" in args else "step_readings.json"
        return step_readings(torch, seeds, out, damsm="--damsm" in args)
    secs = _build.build()
    print(f"built kernels {list(_build.KERNELS)} in {secs:.1f} s", flush=True)
    for name in _build.KERNELS:
        for entry, u in ptxas_entries(_build.build_log(name)):
            print(f"  {name}: {entry}: {u.get('registers')} registers, {u.get('stack_bytes')} "
                  f"bytes stack frame, {u.get('spill_store_bytes')} bytes spill stores, "
                  f"{u.get('spill_load_bytes')} bytes spill loads", flush=True)

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    t0 = time.perf_counter()
    kernels = [attention_phase(torch, rng), attention_bwd_phase(torch, rng),
               *up_head_phase(torch), *glu_requant_phase(torch),
               requant_phase(torch), int8_conv_phase(torch), *glu_requant_f32_phase(torch),
               requant_f32_phase(torch), int8_conv_f32_phase(torch)]
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    # a stream of its own: the x8 phases' data does not depend on this phase
    x16_kernels = x16_kernel_phase(torch, np.random.default_rng(16))
    x16_train_kernels = x16_train_kernel_rows(torch)
    print(f"x16 kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches, scales = pipeline_phase(torch, rng, card)
    tf32_effect(torch, card)
    print(f"pipeline phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for tag, run in serving_phase(torch, rng, card, scales).items():
        launches[f"serving {tag}"] = run
    print(f"serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches["concurrency"] = concurrency_phase(torch, rng, card)
    print(f"concurrency phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # a stream of its own: the later phases' data does not depend on it
        launches.update(aot_phase(torch, np.random.default_rng(17), card, scales, tmp))
    print(f"aot phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            multiprocessing.get_context("spawn").Pool(8) as clients:
        clients.map(abs, range(8))  # the client processes are up before any clock
        launches["http bf16"], launches["http int8"] = http_phase(torch, rng, card, tmp, clients)
        print(f"http phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches.update(x16_phase(torch, card, tmp, clients))
    print(f"x16 phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for tag, run in eval_phase(torch, rng, card).items():
        launches[f"eval {tag}"] = run
    print(f"eval phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(cli_phase(torch, rng, card, tmp))
    print(f"cli phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # a stream of its own: the other phases' data does not depend on it
        launches.update(data_phase(torch, np.random.default_rng(21), card, tmp))
    print(f"data phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # the CPU steps of train_phase (its batch drawn where train_phase drew it)
    # and of eval_variants_phase (a batch of its own stream) run in
    # x16_train_phase's thread, beside its plans, which wait on the card
    cpu_jobs = {"train": (*train_cpu_inputs(torch), train_batch(torch, rng, 4, device="cpu")),
                "variants": (*variants_train_inputs(torch), train_batch(
                    torch, np.random.default_rng(VARIANT_CPU_SEED), 4, device="cpu"))}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        x16_launches, cpu_runs = x16_train_phase(torch, np.random.default_rng(16), card, tmp,
                                                 cpu_jobs)
    launches.update(x16_launches)
    print(f"x16 train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(train_phase(torch, rng, card, tmp, cpu_jobs["train"][2],
                                    cpu_runs["train"]))
    print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    # under PyTorch's default TF32 switches (cuDNN's on), as a user's run of
    # the CLIs has them: the trainers and the ranking turn TF32 off
    with tempfile.TemporaryDirectory() as tmp, torch.backends.cudnn.flags(
            enabled=True, allow_tf32=True):
        launches.update(damsm_phase(torch, rng, card, tmp))
    print(f"damsm phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # a stream of its own: the other phases' data does not depend on it
        variant_launches, map_rows = eval_variants_phase(
            torch, np.random.default_rng(18), card, tmp, cpu_jobs["variants"][2],
            cpu_runs["variants"])
    launches.update(variant_launches)
    print(f"eval variants phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # a stream of its own: the other phases' data does not depend on it
        launches.update(gru_phase(torch, np.random.default_rng(19), card, tmp))
    print(f"gru phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(library_phase(torch))
    print(f"library phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # a stream of its own: the other phases' data does not depend on it
        launches.update(train_scale_phase(torch, np.random.default_rng(20), card, tmp))
    print(f"train scale phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    probe_rows, launches["conv_probe"] = conv_probe_phase(torch)
    kernels += probe_rows
    print(f"conv probe phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # launches: the runs of each path, the serving forward in f32, bf16 and
    # int8, the CLIs' runs, the x16 family's runs, the training runs ("train
    # float32", "train bfloat16", "train cli"), the DAMSM terms' GAN runs
    # ("damsm gan float32", "damsm gan bfloat16", "damsm gan cli"), the
    # data-parallel and sharded steps ("train dp float32", "train fsdp
    # float32", and in bfloat16) and the conv probe (counted
    # apart per path; "launches" is their sum); "x16": the kernel at the x16
    # family's shapes, its launches those of the x16 runs
    for k in kernels:
        k["launches"] = sum(run[k["name"]] for run in launches.values())
        k["launches_by_path"] = {tag: run[k["name"]] for tag, run in launches.items()}
        for tag in ("float32", "bfloat16"):
            if tag in k:  # the backward's: its training run in that dtype
                path = f"train {tag}" if k["name"].endswith("_bwd") else tag
                k[tag]["launches"] = launches[path][k["name"]]
        if k["name"].startswith("word_pixel_attention"):
            k["train"] = {tag: run[k["name"]] for tag, run in launches.items()
                          if tag.startswith("train")}
        if k["name"] in x16_kernels:
            k["x16"] = x16_kernels[k["name"]]
            k["x16"]["launches"] = sum(run[k["name"]] for tag, run in launches.items()
                                       if tag.startswith("x16"))
        if k["name"] in map_rows:  # rows 2 and 3 blending a weight map (EVAL.WEIGHTMAP)
            k["weight_map"] = map_rows[k["name"]]
            k["weight_map"]["launches"] = sum(run[k["name"]] for tag, run in launches.items()
                                              if tag.startswith("variants") and "map" in tag)
        if k["name"] in x16_train_kernels:
            k["x16_train"] = x16_train_kernels[k["name"]]
            k["x16_train"]["launches"] = sum(run[k["name"]] for tag, run in launches.items()
                                             if tag.startswith("train x16"))
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
