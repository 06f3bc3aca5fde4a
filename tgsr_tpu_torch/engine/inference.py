"""Text-guided SR inference (counterpart of tgsr_tpu/engine/inference.py
`SRPipeline`): caption -> TextEncoder -> low branch -> HF branch -> SR, for
the families `config.check_served` names: x8 (BRANCH_NUM 4, GSRNetLow ->
NetGHighWeight, 256 px from 32 px at face S8; GSRNetLowStage1 under
EVAL.STAGE1) and x16 (BRANCH_NUM 5, GSRNetLow16 -> NetGHighWeight16,
models/models16.py, 512 px), picked by `models16.make_generators` as the
JAX package's family switch picks them. The HF branch reads the input
EVAL.INPUT_NETGH names (the LR, its blur, or the LR less its blur: JAX's
`_lr_blur`, taken inside netGH's forward, so every graph and exported
program holds it) and blends a scalar `a` or, under EVAL.WEIGHTMAP, its
per-pixel maps.

Public layouts are the JAX package's: lr [B, h, w, 3] in [-1, 1] (or uint8
for `forward_scan` / `sr_batched`), captions [B, T] token ids with 0 = pad,
sr [B, H, W, 3]. Inside, the generators run NCHW, in channels_last memory on
the card, so NHWC <-> NCHW at the kernel sites costs no copy.

The pipeline runs on `device`, "cuda" unless the caller asks for the CPU.
On the card the attention site of each stage (3 in x8, 4 in x16; 1 under
STAGE1) and the up-head sites (two; one under STAGE1, whose low branch has
none) launch the port's CUDA kernels; on the CPU they run the plain versions, so a pipeline
built with device="cpu" on the same weights is the reference the card's is
held against.

`compute_dtype` is float32 or bfloat16, with the JAX pipeline's casts
(tgsr_tpu/engine/inference.py `_forward_fn`, `forward_scan`): the text
encoder runs in float32 and its outputs are cast; the LR image and every
floating-point parameter and buffer of both generators (BN statistics and
the blend `a` included) are cast; sr, the pyramid and the attention maps
come back float32, and uint8 egress rounds the float32 of the last image.
The up-head sites run `fused_up_head` (float32) or `fused_up_head_packed`
(bfloat16), whose weights are folded and packed once from the float32
weights before the cast, and held as the buffers of a site module
(`UpHeadSite`).

`ServingForward` is the forward every entry point runs: the text encoder,
the two served generators and their up-head sites as one `nn.Module` from
(LR, token ids, lengths) to the uint8 SR. `SRPipeline._serve` (and with it
every captured graph) calls it, `__call__` and `sr_arbitrary` call its
`pyramid`, and `engine/aot.py` exports it, so the live pipeline and an
exported program run one module.

int8 serving (`quant_scales`, with bfloat16 or float32 compute; see
engine/quant.py and models/quantized.py): the scales are checked against the
float32 weights (keys, and the weights fingerprint when they carry one), and
each generator with a non-empty scales group is served by a quantized copy
made after the cast, as JAX quantizes the cast variables; activations stay
in the compute dtype between the int8 convs, as in JAX. Its convs launch
`int8_conv` and its GLU+requantize passes `glu_requant` (their float32
instances under float32 compute); its last stage and
last scale run as modules (the quantized UpBlock, then the int8 head), so
the up-head kernels do not run. The x16 family's tied stage and head are one
module in the quantized copy too, quantized once under the JAX tree's names
(h_net2, img_net1) with the absmax of all their calls. `calibrate_quant` records the scales on the
plain, unfused modules.

Serving: on the card `forward_scan` (and with it `sr_batched`, `sr_uint8`
and engine/serving.py `BatchingServer`) replays the forward of one
microbatch as a CUDA graph, captured once per (graph batch, LR size,
caption length, LR dtype) (engine/graphs.py): a microbatch of b is padded
by replicas to `graph_batch(b)` (a power of two up to 64, then a multiple
of 64) and cropped, and at most MAX_GRAPHS graphs are kept. On the CPU it
runs the same forward eagerly at b. `sr_batched` plans its microbatch from the card's memory
(`plan_microbatch`). `sr_arbitrary` runs eagerly, since its shapes vary.
Every entry point may be called from many threads at once: they take the
pipeline's one lock (`SRPipeline.lock`) in turn, so a replay, a capture and
an eager forward never overlap. Weights come from seeded or JAX state
dicts, from the reference's checkpoints (`from_reference_checkpoints`), or
from a deployment bundle (`save_artifact` / `load_artifact`, the JAX
package's bundle layout; JAX's own bundles load too).

Over several processes (`mesh`, one rank per GPU): each rank runs its rows
of every batch and gathers the whole result, as the JAX pipeline's
batch-sharded program; `sr_spatial` splits one image's rows over the ranks
instead (`parallel/spatial.py`). `fused_upsample` and `fused_up` are JAX's
fused-upsample switches, off by default (see `SRPipeline`).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from tgsr_tpu_torch.checkpoints.from_jax import (conv_sites, seeded_text_state_dict,
                                                 state_dicts_from_jax)
from tgsr_tpu_torch.checkpoints.msgpack_io import load_variables
from tgsr_tpu_torch.checkpoints.reference import (DEFAULT_A, load_generator_pair,
                                                  load_text_encoder)
from tgsr_tpu_torch.config import Config, check_served, config_from_dict, config_to_dict
from tgsr_tpu_torch.data.tokenizer import Vocab
from tgsr_tpu_torch.engine.graphs import (MAX_GRAPHS, MICROBATCH_QUANTUM, ForwardGraph,
                                          GraphCache, graph_batch)
from tgsr_tpu_torch.engine.precision import COMPUTE_DTYPES, cast_floats, pin_float32_math
from tgsr_tpu_torch.engine.quant import (FUSED_UP_SITES, SCALES_META_KEY, SPLIT_RES_GLU_SITES,
                                         check_scales, effective_split_glu, record_absmax,
                                         split_scales_meta, weights_fingerprint)
from tgsr_tpu_torch.models.models16 import make_generators, unused_blocks
from tgsr_tpu_torch.models.quantized import quantize_generator
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tgsr_tpu_torch.ops.blocks import nchw, nhwc
from tgsr_tpu_torch.ops.image import bucket_shape
from tgsr_tpu_torch.ops.up_head import UpHeadSite, up_head_site
from tgsr_tpu_torch.ops.up_head_packed import prepare_up_head_packed, up_head_packed_site
from tgsr_tpu_torch.parallel import spatial
from tgsr_tpu_torch.parallel.mesh import batch_group, batch_shards, data_index
from tgsr_tpu_torch.parallel.multihost import all_gather_cat, all_reduce_min
from tgsr_tpu_torch.utils import memory

# sr_batched's microbatch on the CPU, where no memory plan runs
CPU_MICROBATCH = 64
# a deployment bundle's weights: the three reference-named state dicts and a
BUNDLE_WEIGHTS = "state_dicts.pt"
DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tgsr_tpu_torch runs on a CUDA card by default and "
                           "none is available; pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def to_uint8(sr: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8, round(clip((sr + 1) * 127.5, 0, 255)) with
    round-half-to-even, as the JAX package."""
    return torch.round(torch.clamp((sr + 1.0) * 127.5, 0, 255)).to(torch.uint8)


class ServingForward(nn.Module):
    """One pipeline's serving forward as a module (counterpart of the `fn`
    that tgsr_tpu/engine/aot.py exports): lr float32 [B, h, w, 3] in
    [-1, 1], captions [B, T] int64 token ids (0 = pad), cap_lens [B] int64
    -> the final SR, uint8 [B, H, W, 3] (the save-time postprocess) or, with
    `uint8` False, float32 in [-1, 1]. It holds the pipeline's modules (the
    float32 text encoder, the served generators, int8 copies where
    quantized, and their up-head site modules) and copies no weight."""

    def __init__(self, text_encoder: nn.Module, netg: nn.Module, netgh: nn.Module,
                 netg_up_head: Optional[nn.Module], netgh_up_head: Optional[nn.Module],
                 compute_dtype: torch.dtype, uint8: bool = True):
        super().__init__()
        self.text_encoder, self.netg, self.netgh = text_encoder, netg, netgh
        # None in int8 serving: the last UpBlock and its head are quantized modules
        self.netg_up_head, self.netgh_up_head = netg_up_head, netgh_up_head
        self.compute_dtype = compute_dtype
        self.uint8 = uint8

    def pyramid(self, lr: torch.Tensor, captions: torch.Tensor, cap_lens: torch.Tensor,
                need_attn: bool = False):
        """lr [B, h, w, 3] float32 -> (NCHW pyramid and attn maps, in the
        compute dtype)."""
        cdt = self.compute_dtype
        words, sent = self.text_encoder(captions, cap_lens)
        mask = captions == 0
        lr_c = nchw(lr.contiguous()).to(cdt)
        fake, att, _, _ = self.netg(lr_c, sent.to(cdt), words.to(cdt), mask,
                                    need_attn, up_head=self.netg_up_head)
        return self.netgh(lr_c, fake, up_head=self.netgh_up_head), att

    def forward(self, lr: torch.Tensor, captions: torch.Tensor,
                cap_lens: torch.Tensor) -> torch.Tensor:
        fine, _ = self.pyramid(lr, captions, cap_lens)
        sr = fine[-1].float()
        return nhwc(to_uint8(sr)) if self.uint8 else nhwc(sr)


class SRPipeline:
    """Text-guided SR inference: (LR, captions, cap_lens) -> SR.

    Construct from reference-named state dicts (`checkpoints.from_jax`) and
    the blend weight `a`, which the reference state dict does not carry
    (None for 0.5; not read under EVAL.WEIGHTMAP, whose maps are netGH
    state-dict entries). `quant_scales` ({"netg": {...}, "netgh": {...}},
    optionally with '_meta') selects int8 serving.

    `fused_upsample` (JAX's switch; the x8 family alone, x16 ignores it):
    every UpBlock runs as one 2x2 conv at the source resolution and a
    depth-to-space (`UpBlock(fused=True)`); the up-head sites fuse their
    upsample either way. Under int8 a fused UpBlock stays in the compute
    dtype, as JAX's interceptor leaves it. `fused_up`: the UpBlock convs (JAX
    keys) that int8 serving runs by phases (`int8_upconv_phases`), by
    default engine/quant.py FUSED_UP_SITES, which is empty.

    `mesh` (a `parallel.mesh.make_mesh` DeviceMesh, one process per GPU):
    every rank passes the whole batch and runs its own rows of it (the batch
    padded by replicas to a multiple of the data shards); `__call__`,
    `forward_scan` and `sr_batched` return the whole batch, in order, on
    every rank (an all-gather over the batch group). `sr_spatial` splits one
    image's height over the mesh's 'data' axis instead. Both are collectives:
    every rank makes the same calls, in the same order."""

    def __init__(self, cfg: Config, vocab_size: int,
                 text_sd: Mapping[str, Any], netg_sd: Mapping[str, Any],
                 netgh_sd: Mapping[str, Any], a: Optional[float] = 0.5,
                 device: Union[str, torch.device] = "cuda",
                 return_attn: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 quant_scales: Optional[Mapping[str, Any]] = None,
                 fused_upsample: bool = False, fused_up: Optional[frozenset] = None,
                 mesh=None):
        check_served(cfg)
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: the port serves "
                             f"{COMPUTE_DTYPES}")
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.device = resolve_device(device)
        self.return_attn = return_attn
        self.compute_dtype = compute_dtype
        self.fused_upsample = fused_upsample and cfg.TREE.BRANCH_NUM == 4
        self.fused_up = FUSED_UP_SITES if fused_up is None else frozenset(fused_up)
        self.mesh = mesh
        # the float32 weights as given, for save_artifact
        self.state_dicts = tuple({k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
                                 for sd in (text_sd, netg_sd, netgh_sd))
        # the scalar blend weight; None under a weight map
        self.a = None if cfg.EVAL.WEIGHTMAP else DEFAULT_A if a is None else float(a)
        self.text_encoder, self.netg, self.netgh = _modules(cfg, vocab_size, *self.state_dicts,
                                                            fused_upsample=self.fused_upsample)
        for module in (self.text_encoder, self.netg, self.netgh):
            # serving only: no parameter takes a gradient (a tracer then sees
            # the kernels' ops, not the autograd around them)
            module.to(self.device).eval().requires_grad_(False)
        if self.a is not None:
            self.netgh.a.fill_(self.a)
        self.quant_scales, self.quant_meta = split_scales_meta(quant_scales or {})
        # float32 serving on the card is float32: PyTorch's default has cuDNN's
        # TF32 on, which rounds the convolutions' operands to a 10-bit mantissa
        # (70.0 dB, at most 1 uint8 level, on the face S8 path on an H100:
        # PERF.md). Off for the process, not restored, in one logged line
        # (`pin_float32_math`); bfloat16 and int8 leave the switches as they are
        self.pins_float32_math = (compute_dtype == torch.float32 and not self.quant_scales
                                  and self.device.type == "cuda")
        if self.pins_float32_math:
            pin_float32_math()
        check_scales(self.quant_scales, self.netg, self.netgh, meta=self.quant_meta)
        # the up-head sites of the generators served unquantized, folded (and
        # packed) once from the float32 weights; the text encoder stays
        # float32
        self.netg_up_head = self._up_head_site(self.netg, "netg")
        self.netgh_up_head = self._up_head_site(self.netgh, "netgh")
        for module in (self.netg, self.netgh):
            cast_floats(module, compute_dtype)
            if self.device.type == "cuda":
                module.to(memory_format=torch.channels_last)
        # the modules that serve: int8 copies where a scales group is given,
        # quantized from the cast weights (after the layout change, which
        # would otherwise restride their int8 buffers)
        sites = conv_sites(self.netg, self.netgh)
        self.serve_netg, self.serve_netgh = (
            quantize_generator(module, sites[group], self.quant_scales[group],
                               effective_split_glu(self.quant_scales[group]),
                               SPLIT_RES_GLU_SITES, self.fused_up)
            if self.quant_scales.get(group) else module
            for group, module in (("netg", self.netg), ("netgh", self.netgh)))
        self.serving = self.serving_forward()
        # One re-entrant lock serialises every use of the device by this
        # pipeline: `_graph` (the LRU and any capture), each replay's copy-in,
        # replay and copy-out, the eager forwards of `__call__` /
        # `sr_arbitrary` / `calibrate_quant`, the memory probes and the
        # copies to the host. A graph's static inputs and output are shared
        # by every caller of its key, so two threads interleaved there would
        # swap images without an error; and a capture (`torch.cuda.graph`,
        # "global" capture mode) fails if another thread launches or copies
        # on the card while it runs. Callers that run device work of their
        # own beside the pipeline (engine/evaluator.py) take `lock` too.
        self.lock = threading.RLock()
        # on the card: the captured forwards (`_graph`) and the memory plan
        self.graphs = GraphCache()
        self.memory_plan: Optional[memory.MemoryPlan] = None
        self._plan_key: Optional[tuple] = None  # plan_microbatch's arguments of memory_plan
        # sr_spatial's forward over row shards, made at its first call per mesh
        self._spatial: Optional[Tuple[Any, ServingForward]] = None

    # -- construction from files -------------------------------------------

    @classmethod
    def from_reference_checkpoints(cls, cfg: Config, vocab_size: int, netg_path: str,
                                   netgh_path: Optional[str] = None,
                                   text_encoder_path: Optional[str] = None,
                                   text_seed: int = 100, **kw) -> "SRPipeline":
        """The reference's loading rules (trainer_objective.py:74-93):
        netGH's path is netG's with netG -> netGH in the basename; a `.pth`
        loads as it is (reference key names), with a = 0.5; a `.msgpack`
        pair is a flax tree with its own a (checkpoints/reference.py). The
        text encoder is a `.pth` or a flax tree; without one the weights are
        seeded from `text_seed` (`from_jax.seeded_text_state_dict`, which
        does not reproduce the JAX package's PRNGKey(text_seed) init)."""
        netg_sd, netgh_sd, a = load_generator_pair(cfg, netg_path, netgh_path)
        if text_encoder_path:
            text_sd = load_text_encoder(text_encoder_path, cfg.RNN_TYPE)
        else:
            text_sd = seeded_text_state_dict(cfg, vocab_size,
                                             torch.Generator().manual_seed(text_seed))
        return cls(cfg, vocab_size, text_sd, netg_sd, netgh_sd, a=a, **kw)

    def save_artifact(self, path: str, vocab: Optional[Vocab] = None,
                      return_attn: Optional[bool] = None) -> str:
        """One-directory deployment bundle, the JAX package's layout:
        config.json (`config_to_dict`), meta.json (vocab_size, compute
        dtype, return_attn), quant_scales.json (an int8 pipeline's scales,
        stamped with the weights' fingerprint), vocab.json (optional), and
        the weights in BUNDLE_WEIGHTS: {'text', 'netg', 'netgh'} float32
        state dicts and 'a' (none under a weight map: netgh carries a1..),
        where JAX writes variables.msgpack. Load with
        `SRPipeline.load_artifact(path)`."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config_to_dict(self.cfg), f, indent=1, sort_keys=True)
        text_sd, netg_sd, netgh_sd = self.state_dicts
        torch.save({"text": text_sd, "netg": netg_sd, "netgh": netgh_sd,
                    **({} if self.a is None else {"a": self.a})},
                   os.path.join(path, BUNDLE_WEIGHTS))
        if self.quant_scales:
            # the bundle's scales are bound to the bundle's weights
            meta = {**self.quant_meta, "weights_fingerprint": self.weights_fingerprint()}
            with open(os.path.join(path, "quant_scales.json"), "w") as f:
                json.dump({**self.quant_scales, SCALES_META_KEY: meta}, f, indent=1,
                          sort_keys=True)
        if vocab is not None:
            with open(os.path.join(path, "vocab.json"), "w") as f:
                json.dump({"ixtoword": vocab.ixtoword}, f)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"vocab_size": self.vocab_size,
                       "compute_dtype": str(self.compute_dtype).split(".")[-1],
                       "return_attn": self.return_attn if return_attn is None else return_attn},
                      f)
        return path

    @classmethod
    def load_artifact(cls, path: str, device: Union[str, torch.device] = "cuda",
                      compute_dtype: Optional[torch.dtype] = None,
                      use_quant: Optional[bool] = None, **kw
                      ) -> Tuple["SRPipeline", Optional[Vocab]]:
        """(pipeline, vocab or None) from a bundle of `save_artifact`, or of
        the JAX package's `save_artifact` (variables.msgpack). The JAX
        contract: `compute_dtype` and kw override the saved settings;
        use_quant None serves as bundled, True requires bundled scales
        (ValueError without), False ignores them."""
        with open(os.path.join(path, "config.json")) as f:
            cfg = config_from_dict(json.load(f))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        weights = os.path.join(path, BUNDLE_WEIGHTS)
        if os.path.exists(weights):
            w = torch.load(weights, map_location="cpu", weights_only=True)
            sds = (w["text"], w["netg"], w["netgh"], w.get("a"))
        else:
            v = load_variables(os.path.join(path, "variables.msgpack"))
            sds = state_dicts_from_jax(v["text"], v["netg"], v["netgh"])
        scales = None
        scales_path = os.path.join(path, "quant_scales.json")
        if os.path.exists(scales_path):
            with open(scales_path) as f:
                scales = json.load(f)
        if use_quant and scales is None:
            raise ValueError(f"{path} has no quant_scales.json: re-save from an int8 "
                             "pipeline or calibrate_quant()")
        if use_quant is False:
            scales = None
        vocab = None
        vocab_path = os.path.join(path, "vocab.json")
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                ixtoword = {int(k): w for k, w in json.load(f)["ixtoword"].items()}
            vocab = Vocab(ixtoword, {w: i for i, w in ixtoword.items()})
        if compute_dtype is None:
            if meta["compute_dtype"] not in DTYPE_NAMES:
                raise NotImplementedError(f"compute dtype {meta['compute_dtype']!r}: the port "
                                          f"serves {sorted(DTYPE_NAMES)}")
            compute_dtype = DTYPE_NAMES[meta["compute_dtype"]]
        kw.setdefault("return_attn", meta.get("return_attn", False))
        text_sd, netg_sd, netgh_sd, a = sds
        pipe = cls(cfg, meta["vocab_size"], text_sd, netg_sd, netgh_sd, a=a, device=device,
                   compute_dtype=compute_dtype, quant_scales=scales, **kw)
        return pipe, vocab

    def weights_fingerprint(self) -> str:
        """`engine.quant.weights_fingerprint` of the float32 generators as
        given (before any cast), the JAX package's fingerprint of the same
        weights."""
        _, netg, netgh = _modules(self.cfg, self.vocab_size, *self.state_dicts)
        return weights_fingerprint(netg, netgh)

    def _up_head_site(self, generator, group: str) -> Optional[nn.Module]:
        if self.quant_scales.get(group) or not generator.has_up_head_site:
            # int8: the UpBlock and its head run as quantized modules; the
            # stage-1 low branch has no upsample that feeds only a head
            return None
        wts = generator.up_head_weights()
        if self.compute_dtype == torch.float32:
            return UpHeadSite(up_head_site, wts)
        return UpHeadSite(up_head_packed_site, prepare_up_head_packed(
            wts.w_up, wts.bn_mul, wts.bn_add, wts.w_head, dtype=self.compute_dtype))

    def serving_forward(self, uint8: bool = True) -> ServingForward:
        """The module of this pipeline's serving forward (`ServingForward`),
        on its modules: uint8 out, or float32 with `uint8` False."""
        return ServingForward(self.text_encoder, self.serve_netg, self.serve_netgh,
                              self.netg_up_head, self.netgh_up_head, self.compute_dtype,
                              uint8)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    @torch.inference_mode()
    def calibrate_quant(self, lr, captions, cap_lens, margin: float = 1.1
                        ) -> Dict[str, Dict[str, float]]:
        """int8 activation scales from representative inputs (counterpart of
        tgsr_tpu's `SRPipeline.calibrate_quant`): one forward of the plain
        generators in the compute dtype, through their unfused modules, with
        every conv input's absmax recorded; netgh is calibrated on netg's
        unquantized pyramid. Returns {"netg": {...}, "netgh": {...}} of
        absmax * margin, keyed by the JAX conv paths, for `quant_scales=`."""
        cdt = self.compute_dtype
        sites = conv_sites(self.netg, self.netgh)
        with self.lock:
            captions = self._tensor(captions, torch.long)
            words, sent = self.text_encoder(captions, self._tensor(cap_lens, torch.long))
            lr_c = nchw(self._tensor(lr, torch.float32).contiguous()).to(cdt)
            with record_absmax(self.netg, sites["netg"]) as rec_g:
                fake, _, _, _ = self.netg(lr_c, sent.to(cdt), words.to(cdt), captions == 0)
            with record_absmax(self.netgh, sites["netgh"]) as rec_gh:
                self.netgh(lr_c, fake)
        return {group: {k: float(v) * margin for k, v in rec.items()}
                for group, rec in (("netg", rec_g), ("netgh", rec_gh))}

    @torch.inference_mode()
    def __call__(self, lr, captions, cap_lens) -> Dict[str, Any]:
        """Returns float32 {'sr': [B, H, W, 3], 'pyramid': the low-to-high
        images NHWC (64, 128, 256 px at face S8; 64 to 512 px at S16), and
        'attn': [B, T, H, W] per stage when return_attn}."""
        with self.lock:
            lr = self._tensor(lr, torch.float32)
            captions = self._tensor(captions, torch.long)
            cap_lens = self._tensor(cap_lens, torch.long)
            n = lr.shape[0]
            if self.mesh is not None:
                rows = self._mesh_rows(n)
                lr, captions, cap_lens = lr[rows], captions[rows], cap_lens[rows]
            fine, att = self.serving.pyramid(lr, captions, cap_lens, self.return_attn)
            pyramid = [nhwc(f).float() for f in fine]
            attn = [a.float() for a in att] if self.return_attn else []
            if self.mesh is not None:
                pyramid = [self._gather_rows(x, n) for x in pyramid]
                attn = [self._gather_rows(x, n) for x in attn]
            out = {"sr": pyramid[-1], "pyramid": pyramid}
            if self.return_attn:
                out["attn"] = attn
        return out

    def _mesh_rows(self, n: int) -> torch.Tensor:
        """This rank's rows of a batch of n under `mesh`: its data shard of
        the batch padded by replicas to a multiple of the shards (padded row
        i is row i % n)."""
        if n == 0:
            raise ValueError("mesh serving needs a batch of at least one image")
        per = -(-n // batch_shards(self.mesh))
        start = data_index(self.mesh) * per
        return torch.arange(start, start + per, device=self.device) % n

    def _gather_rows(self, x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """Every rank's rows of x along `dim` (the batch group's, rank
        order), the padding dropped: the whole batch of n."""
        return all_gather_cat(x, batch_group(self.mesh), dim).narrow(dim, 0, n)

    @torch.inference_mode()
    def sr_spatial(self, lr, captions, cap_lens, mesh=None) -> Dict[str, Any]:
        """The forward with the image height split over the 'data' axis of
        `mesh` (or the pipeline's), counterpart of the JAX package's
        `sr_spatial` (tgsr_tpu/engine/inference.py:374-407): every rank
        passes the whole batch and runs its rows of every activation, each
        convolution (and the kernel sites, and the blur of INPUT_NETGH
        'lrblur' / 'lr-lrblur') on its rows and the halo rows it needs from
        its neighbours, exchanged point to point (`parallel/spatial.py`); the
        text path runs whole on every rank. Returns `__call__`'s dict, whole,
        on every rank. The LR height must divide by the shards."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError("sr_spatial needs a mesh: pass mesh= or construct the "
                             "pipeline with one")
        with self.lock:
            if self._spatial is None or self._spatial[0] is not mesh:
                self._spatial = (mesh, spatial.shard_serving(self.serving, spatial.RowShards(
                    mesh, self.device)))
            forward = self._spatial[1]
            shards = forward.rows
            lr = self._tensor(lr, torch.float32)
            fine, att = forward.pyramid(shards.local(lr, dim=1),
                                        self._tensor(captions, torch.long),
                                        self._tensor(cap_lens, torch.long), self.return_attn)
            pyramid = [nhwc(shards.gather(f.float(), dim=2)) for f in fine]
            out = {"sr": pyramid[-1], "pyramid": pyramid}
            if self.return_attn:
                out["attn"] = [shards.gather(a.float(), dim=2) for a in att]
        return out

    def _serve(self, lr: torch.Tensor, captions: torch.Tensor,
               cap_lens: torch.Tensor) -> torch.Tensor:
        """The forward of one microbatch on the device, uint8 in or out:
        lr [B, h, w, 3] (uint8, normalized here, or float in [-1, 1]) ->
        uint8 SR [B, H, W, 3] through `serving`. What a graph captures."""
        if lr.dtype == torch.uint8:
            lr = lr.float() / 127.5 - 1.0
        return self.serving(lr.float(), captions, cap_lens)

    # the batch a microbatch of b replays at on the card (engine/graphs.py)
    graph_batch = staticmethod(graph_batch)

    def _graph(self, b: int, h: int, w: int, t: int, lr_dtype: torch.dtype) -> ForwardGraph:
        """The captured forward at batch b (a `graph_batch` size), LR h x w,
        caption length t, LR uint8 or float32 (any float LR is copied into a
        float32 buffer); captured at first use. Past MAX_GRAPHS the least
        recently used graph is dropped, with its inputs and output. The
        caller holds `lock`."""
        lr_dtype = torch.uint8 if lr_dtype == torch.uint8 else torch.float32
        return self.graphs.graph(
            (b, h, w, t, lr_dtype), self._serve,
            lambda: (torch.zeros((b, h, w, 3), dtype=lr_dtype, device=self.device),
                     torch.ones((b, t), dtype=torch.long, device=self.device),
                     torch.full((b,), t, dtype=torch.long, device=self.device)),
            MAX_GRAPHS, self.device)

    @torch.inference_mode()
    def forward_scan(self, lr, captions, cap_lens) -> torch.Tensor:
        """lr [M, B, h, w, 3] (uint8, or float in [-1, 1]), captions
        [M, B, T], cap_lens [M, B] -> uint8 SR [M, B, H, W, 3] on the device,
        one microbatch of B after another: on the card, replays of the
        forward captured at `graph_batch(B)` (captured at the first call of
        that shape), each microbatch padded by replicas of its own images
        and cropped; on the CPU, the same forward run eagerly at B. Holds
        `lock` throughout: the capture, and each replay from its copy-in to
        the copy of its output into the result. Under `mesh` each rank runs
        its rows of every microbatch, and the result is gathered whole."""
        with self.lock:
            lr = self._tensor(lr)
            captions = self._tensor(captions, torch.long)
            cap_lens = self._tensor(cap_lens, torch.long)
            if self.mesh is None:
                return self._scan(lr, captions, cap_lens)
            n = lr.shape[1]
            rows = self._mesh_rows(n)
            return self._gather_rows(self._scan(lr[:, rows], captions[:, rows],
                                                cap_lens[:, rows]), n, dim=1)

    def _scan(self, lr: torch.Tensor, captions: torch.Tensor,
              cap_lens: torch.Tensor) -> torch.Tensor:
        """`forward_scan` of this rank's rows. The caller holds `lock`."""
        s = self.cfg.scale
        m, b, h, w, _ = lr.shape
        serve = self._serve
        if self.device.type == "cuda":
            bg = self.graph_batch(b)
            if bg > b:
                sel = torch.arange(bg, device=self.device) % b
                lr, captions, cap_lens = lr[:, sel], captions[:, sel], cap_lens[:, sel]
            serve = self._graph(bg, h, w, captions.shape[-1], lr.dtype)
        out = torch.empty((m, b, h * s, w * s, 3), dtype=torch.uint8, device=self.device)
        for i in range(m):
            out[i] = serve(lr[i], captions[i], cap_lens[i])[:b]
        return out

    @torch.inference_mode()
    def _probe_need(self, b: int) -> int:
        """Peak device bytes the caching allocator reserves for one eager
        uint8 microbatch forward at b. The caller holds `lock`."""
        t, size = self.cfg.TEXT.WORDS_NUM, self.cfg.TREE.BASE_SIZE
        lr = torch.zeros((b, size, size, 3), dtype=torch.uint8, device=self.device)
        captions = torch.ones((b, t), dtype=torch.long, device=self.device)
        cap_lens = torch.full((b,), t, dtype=torch.long, device=self.device)
        return memory.peak_bytes(lambda: self._serve(lr, captions, cap_lens), self.device)

    def plan_microbatch(self, budget_bytes: Optional[int] = None,
                        quantum: int = MICROBATCH_QUANTUM, lo: int = 1,
                        hi: int = memory.MAX_MICROBATCH) -> int:
        """The largest microbatch in [lo, hi] (a multiple of `quantum`, or a
        power of two below it, or lo itself) that fits the card: its forward
        twice over, as a graph's pool and an eager forward of the same size
        beside it (the warm-up before a capture), plus the static inputs and
        outputs of the MAX_GRAPHS - 1 other graphs the pipeline may keep,
        each at most that size (utils/memory.py). The forward's need is
        measured at two probe batches (`quantum` and PROBE_SPAN times it)
        and fitted linearly, against `budget_bytes`, by default the card's
        free memory times memory.BUDGET_FRACTION; RuntimeError where not even
        lo fits. Planned once per set of arguments, kept with its fitted
        bytes in `memory_plan`. On the CPU: CPU_MICROBATCH, whatever the
        arguments. The counterpart of the JAX package's plan from XLA's
        memory analysis (JAX's arguments; its lo defaults to 64, and where lo
        does not fit it returns its v5e constant DEFAULT_MICROBATCH).

        Under `mesh` a collective over the batch group, which every rank
        calls: each rank plans from its own free memory and probes
        (`memory_plan` is that rank's), and all get the least of the plans,
        so that they run microbatches of one shape (JAX plans once for the
        global program). Where lo fits on no rank's card, every rank raises
        RuntimeError."""
        if self.mesh is None:
            return self._local_microbatch(budget_bytes, quantum, lo, hi)
        try:
            local, fault = self._local_microbatch(budget_bytes, quantum, lo, hi), None
        except RuntimeError as e:  # the other ranks must not wait in the collective
            local, fault = 0, e
        agreed = all_reduce_min(local, batch_group(self.mesh))
        if agreed == 0:
            raise RuntimeError(f"plan_microbatch: a microbatch of {lo} does not fit the "
                               "card of every rank") from fault
        return agreed

    def _local_microbatch(self, budget_bytes: Optional[int], quantum: int, lo: int,
                          hi: int) -> int:
        """`plan_microbatch` on this rank alone."""
        if self.device.type != "cuda":
            return CPU_MICROBATCH
        key = (budget_bytes, quantum, lo, hi)
        with self.lock:
            if self.memory_plan is None or self._plan_key != key:
                t, size, s = self.cfg.TEXT.WORDS_NUM, self.cfg.TREE.BASE_SIZE, self.cfg.scale
                # a graph's float32 LR, token ids and lengths, and uint8 SR
                graph_bytes = size * size * 3 * 4 + (t + 1) * 8 + (size * s) ** 2 * 3
                torch.cuda.empty_cache()
                if budget_bytes is None:
                    budget_bytes = memory.device_memory_budget(self.device)
                self.memory_plan = memory.plan(self._probe_need, budget_bytes, quantum,
                                               (MAX_GRAPHS - 1) * graph_bytes, lo, hi)
                self._plan_key = key
            return self.memory_plan.microbatch

    @staticmethod
    def plan_batches(n: int, microbatch: int) -> Tuple[int, int]:
        """(m, b): N images in m microbatches of b, as the JAX package's
        sr_batched plans them: m = ceil(N / microbatch), b balanced to
        ceil(N / m) and rounded up to a multiple of MICROBATCH_QUANTUM, never
        above the microbatch (N = 65 at microbatch 64 runs 2 x 64)."""
        b = min(microbatch, n)
        m = -(-n // b)
        balanced = -(-n // m)
        return m, min(b, -(-balanced // MICROBATCH_QUANTUM) * MICROBATCH_QUANTUM)

    def sr_batched(self, lr, captions, cap_lens,
                   microbatch: Optional[int] = None) -> np.ndarray:
        """Any number N of images, in microbatches (`plan_batches`); the
        microbatch defaults to `plan_microbatch()` (under `mesh`, the ranks'
        agreed plan times the data shards: each rank runs its share of it).
        The tail is padded by replicating images from the start and stripped
        after. Peak memory is set by the microbatch, not N (the device output
        is N uint8 images).
        Returns uint8 [N, H, W, 3] on the host."""
        lr = np.asarray(lr)
        captions = np.asarray(captions)
        cap_lens = np.asarray(cap_lens)
        n = lr.shape[0]
        s = self.cfg.scale
        if n == 0:
            return np.empty((0, lr.shape[1] * s, lr.shape[2] * s, 3), np.uint8)
        if microbatch is None:
            microbatch = self.plan_microbatch() * (batch_shards(self.mesh) if self.mesh else 1)
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        m, b = self.plan_batches(n, microbatch)
        if m * b > n:
            sel = np.arange(m * b) % n
            lr, captions, cap_lens = lr[sel], captions[sel], cap_lens[sel]
        with self.lock:  # the copy to the host too: no capture may see it
            srs = self.forward_scan(lr.reshape(m, b, *lr.shape[1:]),
                                    captions.reshape(m, b, captions.shape[-1]),
                                    cap_lens.reshape(m, b))
            return srs.reshape(m * b, *srs.shape[2:])[:n].cpu().numpy()

    def sr_uint8(self, lr, captions, cap_lens) -> np.ndarray:
        """lr [B, h, w, 3] float in [-1, 1] -> the final SR as uint8
        [B, H, W, 3] on the host (the save-time clip,
        trainer_objective.py:153-155), through the graph at B on the card."""
        lr = np.asarray(lr, np.float32)
        with self.lock:
            return self.forward_scan(lr[None], np.asarray(captions)[None],
                                     np.asarray(cap_lens)[None])[0].cpu().numpy()

    @torch.inference_mode()
    def sr_arbitrary(self, lr, captions, cap_lens, bucket: Optional[int] = None) -> np.ndarray:
        """lr [1, h, w, 3] float in [-1, 1], any (h, w) -> uint8 SR
        [1, h * scale, w * scale, 3] on the host. bucket=None runs the native
        shape; bucket=N edge-pads (h, w) on the host up to multiples of N
        (`bucket_shape`) and crops the SR, at the cost of the convolutions'
        halo reading the padding. Runs eagerly, since its shapes vary."""
        lr = np.asarray(lr, np.float32)
        if lr.ndim != 4 or lr.shape[0] != 1:
            raise ValueError(f"sr_arbitrary takes lr [1, h, w, 3], got {lr.shape}")
        h, w = lr.shape[1:3]
        if bucket:
            bh, bw = bucket_shape(h, w, 1, bucket)
            lr = np.pad(lr, ((0, 0), (0, bh - h), (0, bw - w), (0, 0)), mode="edge")
        s = self.cfg.scale
        with self.lock:
            sr = self(lr, captions, cap_lens)["sr"][:, :h * s, :w * s]
            return to_uint8(sr).cpu().numpy()


def _modules(cfg: Config, vocab_size: int, text_sd: Mapping[str, Any],
             netg_sd: Mapping[str, Any], netgh_sd: Mapping[str, Any],
             fused_upsample: bool = False):
    """(TextEncoder, netG, netGH of cfg's family) on the CPU in float32,
    with the state dicts loaded strictly."""
    modules = (TextEncoder(vocab_size, 300, cfg.TEXT.EMBEDDING_DIM, rnn_type=cfg.RNN_TYPE),
               *make_generators(cfg, unused_blocks(netgh_sd), fused_upsample=fused_upsample))
    for module, sd in zip(modules, (text_sd, netg_sd, netgh_sd)):
        module.load_state_dict(sd, strict=True)
    return modules
