"""Exported serving programs (counterpart of tgsr_tpu/engine/aot.py, which
serializes the traced forward with jax.export).

`export_serving(pipeline, path)` traces the pipeline's serving forward
(`engine/inference.ServingForward`: text encoder, both generators, the
uint8 postprocess) with `torch.export.export` and writes it with its
weights inside one `.pt2` file (`torch.export.save`). No decomposition is
run: the program keeps the traced ATen ops and the port's custom ops
(`tgsr::word_pixel_attention`, `tgsr::up_head`, `tgsr::up_head_packed`,
`tgsr::int8_conv`, `tgsr::glu_requant`, `tgsr::requant`; ops/library.py),
so on the card it launches the kernels the live pipeline launches, and on
the CPU it runs their plain versions.

Where the port departs from JAX: a JAX artifact needs only JAX, while a
`.pt2` names the `tgsr::` ops, which `torch.export.load` cannot resolve
unless they are registered (it raises a SerializeError). So loading imports
`tgsr_tpu_torch.ops.library`, the one module of the port that registers
them (with the kernels' wrappers and plain versions), and no model module:
a serving host needs torch and that much of the port, no checkpoint, no
config and no model code.

Two-file directory layout:
  forward.pt2   the ExportedProgram, weights inside
  meta.json     JAX's keys (lr_size, words_num, batch, uint8, platforms,
                sr_size, n_words, quantized, compute_dtype) and the torch
                version that exported it

The batch is symbolic by default (`torch.export.Dim`, 1 to MAX_BATCH), so
one artifact serves any batch; batch_size= pins it. `platforms` lists the
device types the artifact may be loaded on ("cpu", "cuda"); the default is
the exporting pipeline's. `load_serving` moves a program exported on another listed
device type with `torch.export.passes.move_to_device_pass`, and refuses a
device type that is not listed.

`AOTPipeline` serves a loaded program with what engine/serving.py's
BatchingServer and cli/serve.py use of an `SRPipeline`: `cfg.TEXT.WORDS_NUM`,
`cfg.TREE.BASE_SIZE`, `cfg.scale`, `meta`, `sr_uint8` and `lock`; like
JAX's, it has no `sr_arbitrary` (the shapes are fixed at export). On the
card it replays the program captured as a CUDA graph per graph batch
(engine/graphs.py), padded by replicas and cropped as `SRPipeline` does; a
pinned artifact pads up to its pin and refuses a batch above it. A float32
artifact turns TF32 off on the card, as a float32 `SRPipeline` does
(`engine/precision.pin_float32_math`).
"""

from __future__ import annotations

import json
import os
import threading
from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tgsr_tpu_torch.engine.graphs import MAX_GRAPHS, ForwardGraph, GraphCache, graph_batch
from tgsr_tpu_torch.engine.precision import pin_float32_math
from tgsr_tpu_torch.ops import library  # noqa: F401 (registers the tgsr:: ops)

FORWARD_FILE = "forward.pt2"
META_FILE = "meta.json"
PLATFORMS = ("cpu", "cuda")
# the example batch a symbolic artifact is traced at: export specializes a
# dimension whose example size is 1
_EXAMPLE_BATCH = 2
# the largest batch of a symbolic artifact: a trace on the card guards the
# batch at CUDA's grid limit of 65535 blocks in y and z
MAX_BATCH = 65535


def export_serving(pipeline, path: str, batch_size: Optional[int] = None,
                   lr_size: Optional[int] = None, uint8: bool = True,
                   platforms: Optional[Sequence[str]] = None) -> str:
    """Export `pipeline`'s (an `SRPipeline`) serving forward under `path/`.

    batch_size: None -> a symbolic batch, any batch at call time.
    lr_size:    the LR size; default cfg.TREE.BASE_SIZE.
    uint8:      bake the save-time postprocess (round(clip((x + 1) * 127.5)))
                into the program, which then returns uint8; False returns
                float32 in [-1, 1].
    platforms:  the device types it may be loaded on, from PLATFORMS;
                default the pipeline's.
    """
    cfg = pipeline.cfg
    lr_size = lr_size or cfg.TREE.BASE_SIZE
    t = cfg.TEXT.WORDS_NUM
    platforms = list(platforms or [pipeline.device.type])
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms {platforms}: an artifact is exported for {PLATFORMS}")
    b = _EXAMPLE_BATCH if batch_size is None else int(batch_size)
    dev = pipeline.device
    args = (torch.zeros((b, lr_size, lr_size, 3), dtype=torch.float32, device=dev),
            torch.ones((b, t), dtype=torch.long, device=dev),
            torch.full((b,), t, dtype=torch.long, device=dev))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
        dynamic = ({0: batch}, {0: batch}, {0: batch})
    with pipeline.lock:
        program = torch.export.export(pipeline.serving_forward(uint8), args,
                                      dynamic_shapes=dynamic, strict=False)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, FORWARD_FILE))
    meta = {
        "lr_size": lr_size,
        "words_num": t,
        "batch": "symbolic" if batch_size is None else int(batch_size),
        "uint8": uint8,
        "platforms": platforms,
        "sr_size": lr_size * cfg.scale,
        "n_words": int(pipeline.vocab_size),
        "quantized": bool(pipeline.quant_scales),
        "compute_dtype": str(pipeline.compute_dtype).split(".")[-1],
        "torch": torch.__version__,
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def _program_device(program) -> torch.device:
    """The device of the program's weights (the device it was traced on)."""
    return next(t.device for t in (*program.state_dict.values(), *program.constants.values())
                if isinstance(t, torch.Tensor))


def load_serving(path: str, device: Union[str, torch.device] = "cuda"
                 ) -> Tuple[nn.Module, Dict[str, Any]]:
    """Load an `export_serving` artifact onto `device`. Returns (module,
    meta): `module(lr, captions, cap_lens)` takes tensors on that device
    (float32 LR, int64 token ids and lengths) and runs the program. Raises
    for a device type the artifact does not list."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    dev = torch.device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not for {dev}: "
                         "re-export with --platforms naming it")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; load the artifact with device='cpu' "
                           "where its platforms list the CPU")
    program = torch.export.load(os.path.join(path, FORWARD_FILE))
    if _program_device(program).type != dev.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    return program.module(), meta


class AOTPipeline:
    """An `SRPipeline` stand-in over an `export_serving` artifact, for
    engine/serving.py's BatchingServer and cli/serve.py: `cfg.TEXT.WORDS_NUM`,
    `cfg.TREE.BASE_SIZE`, `cfg.scale`, `meta`, `quant_scales` (non-empty for
    an int8 artifact), `sr_uint8` and `lock`. No model code loads."""

    def __init__(self, path: str, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        self.module, self.meta = load_serving(path, self.device)
        lr_size = self.meta["lr_size"]
        self.cfg = SimpleNamespace(TEXT=SimpleNamespace(WORDS_NUM=self.meta["words_num"]),
                                   TREE=SimpleNamespace(BASE_SIZE=lr_size),
                                   scale=self.meta["sr_size"] // lr_size)
        self.quant_scales = {"aot": True} if self.meta["quantized"] else {}
        self.compute_dtype = getattr(torch, self.meta["compute_dtype"])
        # float32 on the card is float32, as for SRPipeline (precision.py)
        self.pins_float32_math = (self.compute_dtype == torch.float32 and not self.quant_scales
                                  and self.device.type == "cuda")
        if self.pins_float32_math:
            pin_float32_math()
        # serialises every device use, as SRPipeline.lock
        self.lock = threading.RLock()
        self.graphs = GraphCache()

    def graph_batch(self, n: int) -> int:
        """The batch n images run at: a pinned artifact's pin; else, on the
        card, `graphs.graph_batch(n)`, and n on the CPU."""
        pin = self.meta["batch"]
        if isinstance(pin, int):
            return pin
        return graph_batch(n) if self.device.type == "cuda" else n

    def _graph(self, b: int, t: int) -> ForwardGraph:
        """The program captured at batch b, caption length t (at most
        MAX_GRAPHS kept, as SRPipeline's). The caller holds `lock`."""
        size = self.meta["lr_size"]
        return self.graphs.graph(
            (b, t), self.module,
            lambda: (torch.zeros((b, size, size, 3), dtype=torch.float32, device=self.device),
                     torch.ones((b, t), dtype=torch.long, device=self.device),
                     torch.full((b,), t, dtype=torch.long, device=self.device)),
            MAX_GRAPHS, self.device)

    @torch.inference_mode()
    def sr_uint8(self, lr, captions, cap_lens) -> np.ndarray:
        """lr [N, h, w, 3] float in [-1, 1] -> uint8 SR [N, H, W, 3] on the
        host: one run at `graph_batch(N)`, padded by replicas of the N
        images and cropped (a replay on the card)."""
        lr = np.asarray(lr, np.float32)
        n = lr.shape[0]
        s = self.meta["sr_size"]
        if n == 0:
            return np.empty((0, s, s, 3), np.uint8)
        pin = self.meta["batch"]
        if isinstance(pin, int) and n > pin:
            raise ValueError(f"batch {n} exceeds the artifact's pinned batch {pin}; "
                             "re-export with batch_size=None (symbolic) or a larger pin")
        b = self.graph_batch(n)
        with self.lock:
            x = torch.as_tensor(lr, device=self.device)
            caps = torch.as_tensor(np.asarray(captions), dtype=torch.long, device=self.device)
            lens = torch.as_tensor(np.asarray(cap_lens), dtype=torch.long, device=self.device)
            if b > n:
                sel = torch.arange(b, device=self.device) % n
                x, caps, lens = x[sel], caps[sel], lens[sel]
            run = self._graph(b, caps.shape[-1]) if self.device.type == "cuda" else self.module
            out = run(x, caps, lens)[:n].cpu().numpy()
        if self.meta["uint8"]:
            return out
        # a float artifact: the save-time postprocess on the host
        return np.round(np.clip((out + 1.0) * 127.5, 0, 255)).astype(np.uint8)
