"""Builds the port's CUDA kernels and keeps their launch counts.

Each `.cu` source in `tgsr_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface, loaded
with ctypes. Nothing here includes PyTorch's headers, so a build takes
seconds. Libraries go into `tgsr_tpu_torch/_build/`, named by a hash of the
source and the flags, and are built on first use; `build()` builds several
at once, one nvcc process per source, all started together. A `.c` source
is host code (`host_library`), compiled by the system's C compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("word_pixel_attention", "up_head", "up_head_packed", "glu_requant", "int8_conv",
           "conv_probe")
# the kernels a run counts: one name per library, but the attention's
# backward, the instances of glu_requant.cu (GLU at c = 64 and c = 32,
# requantization alone; bfloat16 and float32 inputs), the bfloat16 and float32
# outputs of int8_conv.cu and the four kernels of conv_probe.cu apart
LAUNCH_NAMES = ("word_pixel_attention", "word_pixel_attention_bwd", "up_head", "up_head_packed",
                "glu_requant_one", "glu_requant_pair", "requant", "int8_conv",
                "glu_requant_one_f32", "glu_requant_pair_f32", "requant_f32", "int8_conv_f32",
                "conv_tap9", "conv_im2col", "conv_pair5", "conv_dotceil")
# element type codes of the kernels that take more than float32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C functions of each library: (argtypes, restype), set once at load
SIGNATURES = {
    "word_pixel_attention": {
        # pixels, words, mask, ctx, attn, B, HW, C, T, dtype, stream
        "word_pixel_attention_launch": ([_P] * 5 + [_I] * 5 + [_P], _I),
        # pixels, words, mask, gctx, gattn, dpixels, dwords, workspace, B, HW,
        # C, T, dtype, stream
        "word_pixel_attention_bwd_launch": ([_P] * 8 + [_I] * 5 + [_P], _I),
        "word_pixel_attention_bwd_workspace": ([_I] * 4, ctypes.c_longlong),
    },
    "up_head": {
        # x, w_up, bn_mul, bn_add, w_head, srb, a, out, B, H, W, Cin, C2, k,
        # tanh, a's row stride (0: a scalar a), stream
        "up_head_launch": ([_P] * 8 + [_I] * 8 + [_P], _I),
        "up_head_smem_bytes": ([_I] * 3, ctypes.c_longlong),
    },
    "up_head_packed": {
        # x, w_up, bn_mul, bn_add, w_head, srb, a, out, B, H, W, Cin, C2,
        # tanh, dtype, a's row stride (0: a scalar a), stream
        "up_head_packed_launch": ([_P] * 8 + [_I] * 8 + [_P], _I),
        "up_head_packed_smem_bytes": ([_I] * 3, ctypes.c_longlong),
    },
    "glu_requant": {
        # h, q, n_pixels, c, step, stream
        "glu_requant_launch": ([_P, _P, ctypes.c_longlong, _I, _F, _P], _I),
        # x, q, n, step, stream
        "requant_launch": ([_P, _P, ctypes.c_longlong, _F, _P], _I),
        # the float32 instances, the same arguments
        "glu_requant_f32_launch": ([_P, _P, ctypes.c_longlong, _I, _F, _P], _I),
        "requant_f32_launch": ([_P, _P, ctypes.c_longlong, _F, _P], _I),
    },
    "int8_conv": {
        # x, w, scale, mul, add, residual, out, B, H, W, Cin, Cout, k, up2,
        # out dtype, stream
        "int8_conv_launch": ([_P] * 7 + [_I] * 8 + [_P], _I),
    },
    "conv_probe": {
        # x, w (HWIO) or wp (packed), out, B, H, W, stream
        "conv_tap9_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
        "conv_im2col_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
        "conv_pair5_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
        # p, wp, out, rows of p, stream
        "conv_dotceil_launch": ([_P] * 3 + [ctypes.c_longlong, _P], _I),
    },
    # host code
    "png_unfilter": {
        # rows, out, h, stride, bytes per pixel
        "png_unfilter": ([_P, _P, ctypes.c_longlong, ctypes.c_longlong, _I], None),
    },
    "jpeg_decode": {
        # data, n, &w, &h, &components, err, err length
        "jpeg_info": ([ctypes.c_char_p, ctypes.c_longlong, _P, _P, _P, ctypes.c_char_p, _I], _I),
        # data, n, out (h x w x 3), out capacity, err, err length
        "jpeg_decode_rgb": ([ctypes.c_char_p, ctypes.c_longlong, _P, ctypes.c_longlong,
                             ctypes.c_char_p, _I], _I),
    },
    "loader": {
        # src, h, w, resized h, resized w, top, left, crop h, crop w, out
        "resize_crop_bilinear": ([_P] + [_I] * 8 + [_P], _I),
    },
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O2", "-shared", "-fPIC")

# launches of each kernel since the last reset_launches(); each wrapper adds
# one where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {name: 0 for name in LAUNCH_NAMES}
# launches made by CUDA graph replays since the last reset_launches(): a
# replay adds the counts its graph recorded while it was captured
# (engine/graphs.py); the wrappers' LAUNCHES do not move on a replay
REPLAYED: Dict[str, int] = {name: 0 for name in LAUNCH_NAMES}

_LIBS: Dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()  # request threads may all ask for a host library at once


def reset_launches() -> None:
    for counts in (LAUNCHES, REPLAYED):
        for name in counts:
            counts[name] = 0


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of tgsr_tpu_torch "
                           "are built from source on the machine with the card")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every library in `names` that is not built yet, in parallel.
    Returns the wall seconds spent; raises with the compiler's output if any
    build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output of the last build of `name` (ptxas -v lines:
    registers, shared memory and spills of each kernel)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use, with the
    ctypes signatures of its C functions set."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = _load(name, lib_path(name))
    return _LIBS[name]


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def host_library(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of the host code `csrc/{name}.c`, compiled by the
    system's C compiler on first use; None where there is no C compiler,
    and the caller runs its Python version. ctypes calls it without the
    interpreter lock."""
    with _HOST_LOCK:
        if name not in _LIBS:
            cc = shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                return None
            src = CSRC / f"{name}.c"
            digest = hashlib.sha256(src.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()
            out = BUILD_DIR / f"lib{name}-{digest[:12]}.so"
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(src)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{name}: C build failed (exit {proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
            _LIBS[name] = _load(name, out)
        return _LIBS[name]


def refuse_grad(what: str, *tensors) -> None:
    """Raises for a serving-only kernel asked to run where autograd would
    need its gradient: the kernel writes its output through raw pointers, so
    the output would carry no grad_fn and the gradient would be lost without
    an error."""
    if torch.is_grad_enabled() and any(t is not None and torch.is_tensor(t) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{what}: a serving kernel with no backward; an input needs a "
                           "gradient (call it under torch.no_grad())")


def check_device(x: torch.Tensor, what: str) -> None:
    """Raises for a tensor on a device that has neither the kernel (CUDA)
    nor the plain version (the CPU): a custom op dispatches by device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {x.device}")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
