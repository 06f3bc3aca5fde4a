"""Adversarial SR training (counterpart of tgsr_tpu/engine/gan_trainer.py,
`GANTrainer` :48-615).

The reference ships no GAN trainer; the JAX package reconstructs the
AttnGAN-style one its loss API implies, and this is that trainer in
PyTorch, step for step:

- Adam(lr, b1 0.5, b2 0.999) per network (G = netG + netGH with its blend
  weight `a`, or under EVAL.WEIGHTMAP its maps a1.. as netGH parameters and
  no `a`; D = one `DNet` per pyramid scale);
- netGH's input as EVAL.INPUT_NETGH names it, the blur of the batch's LR
  taken inside netGH's forward (JAX blurs in the step, as here; the batch
  carries no blur), in the step and in `eval_metrics`;
- the frozen text encoder, its outputs detached; masks from captions == 0;
- one generator forward a step (JAX's `reuse_g_forward=True`, which
  tests/test_remat.py:103 shows equal to its default of two): the D step
  on the detached fine pyramid, then the G step against the *updated* D,
  its loss (adv + KL + pixel MSE on both pyramids, `loss_weights`)
  differentiated through that one forward; with an `image_encoder`, the
  DAMSM word and sentence terms of the finest fake inside adv (JAX's
  `image_encoder_apply`): the encoder frozen, in eval mode, in float32 (the
  loss dtype) whatever the compute dtype, as JAX's sees the float32 fake of
  `g_composite`, and not part of the snapshot. The Inception family's
  backbone runs without autograd (JAX's `stop_gradient`), so its terms add
  to G's loss and send G no gradient; SimpleCNN's do (ROADMAP, Queue C 4);
- BatchNorm in train mode everywhere, the running stats moved in JAX's call
  order: G's in its forward, D's through the D step (real features, fake
  features, then the conditional heads, the mismatched pair at batch b - 1)
  and again through the G step;
- the EMA of G's parameters (0.999); `grad_accum` as `optax.MultiSteps`:
  the running mean of the micro-steps' gradients, applied every
  `grad_accum`-th step, the EMA blended only then;
- `compute_dtype=torch.bfloat16` as JAX's mixed precision
  (`engine/precision.call_cast`): float32 masters, optimizer state, EMA and
  BN running stats; bfloat16 convolutions; float32 losses and BN moments;
  logits back in float32 before the BCE. `compute_dtype=torch.float64`
  computes everything but the text encoder in float64, losses included:
  the reference a float32 step on the card is held against
  (chip_smoke.py train_phase);
- TF32 off in the step and in `super_resolve`
  (`engine/precision.float32_math`), whatever the process's switches say.

- the family switch of JAX's trainer (:143-169): BRANCH_NUM 4 the x8
  generators, 5 the x16 family (models16: h_net2 called three times and
  img_net1 four, residual48 and upscale8x twice, each call moving its BN
  stats in JAX's order; a tied module is one tensor set, its gradients
  summed over its calls, one Adam state), one DNet per pyramid scale (64 to
  512 px at x16);
- `remat` False / True / 'all' / 'low' / 'high' (:132-141) as activation
  checkpointing (`utils/remat.py`): 'low' each GSRNetLow stage, 'high' each
  NetGHighWeight block, True / 'all' both. Memory only: the step equals
  the step without it bit for bit on the CPU, BN running stats included.

Where JAX returns a new state from a jitted step, the port updates the
state in place (its modules, optimizers and EMA) and returns the metrics,
0-d tensors on the device (no host sync). JAX's CANet draws a c_code that
nothing on the SR path reads; the port draws nothing, so a step uses no
random numbers. `plan_batch` bisects capped probe runs where JAX bisects
XLA's compile-time memory, and refuses the CPU (ROADMAP Queue C).

Scale-out (JAX's `mesh` and `fsdp`, :66-108): with `mesh` (a
`parallel.mesh` DeviceMesh; one process per GPU) each rank steps on its own
rows of the global batch and the step is the single-process step on the
global batch, as JAX's ("Math is unchanged vs DP"): train-mode BN takes the
global moments, the losses that couple samples read the other ranks' rows
(`parallel/data_parallel.py`), each per-sample mean is weighted by B_local /
B_global, and the ranks' parameter gradients and metrics are summed (one
flat bucket a dtype). The gradients are never DDP's: `torch.autograd.grad`
bypasses its hooks. `fsdp` (which needs a mesh) stores every parameter, both
Adams' moments, the G EMA and the grad_accum buffers sharded by
`parallel.mesh.fsdp_spec` between steps: the step all-gathers the
parameters, reduce-scatters their gradients and updates each rank's shard
(Adam and the EMA are elementwise, so a shard's update is the same
arithmetic); D is gathered again after its update, for G's step against
it. Under a mesh of one rank every collective is a copy and the step is the
plain step bit for bit.

`GANTrainState.state_dict()` / `load_state_dict()` are the whole train
state (JAX's orbax tree) for `checkpoints/dcp_io.py`: a sharded leaf a
DTensor. `train_steps` runs K steps over a stacked batch;
`clip_norm` (`clip_by_global_norm`, :618) clips each optimizer's gradient
by its global norm, optax's rule, before it is accumulated or applied.
"""

from __future__ import annotations

import gc
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from tgsr_tpu_torch.checkpoints.from_jax import (StateDict, init_module, netg_variables,
                                                 netgh_variables)
from tgsr_tpu_torch.config import Config, check_trained
from tgsr_tpu_torch.engine.inference import resolve_device
from tgsr_tpu_torch.engine.precision import COMPUTE_DTYPES, call_cast, float32_math
from tgsr_tpu_torch.losses.gan import discriminator_loss, generator_loss
from tgsr_tpu_torch.losses.pixel import kl_loss, mse_pyramid
from tgsr_tpu_torch.models.discriminator import DNet
from tgsr_tpu_torch.models.image_encoder import CNNEncoder, SimpleCNNEncoder
from tgsr_tpu_torch.models.models16 import make_generators
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tgsr_tpu_torch.ops.blocks import nchw, nhwc
from tgsr_tpu_torch.parallel import data_parallel
from tgsr_tpu_torch.parallel.mesh import (axis_sizes, batch_group, local_shard, placements,
                                          shard_dim)
from tgsr_tpu_torch.parallel.multihost import device_of_rank
from tgsr_tpu_torch.ops.image import denormalize_to_uint8, psnr_batch, rgb2y, ssim
from tgsr_tpu_torch.utils import memory
from tgsr_tpu_torch.utils.remat import remat_policy

LOSS_TERMS = ("adv", "pixel", "kl", "damsm")
TRAIN_DTYPES = COMPUTE_DTYPES + (torch.float64,)  # float64: the reference precision
A_INIT = 0.5  # the JAX NetGHighWeight's init of params['a']
EMA_DECAY = 0.999  # the JAX trainer's default, which its CLI keeps
ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def gather_dim(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor of the ranks' equal shards along `dim`, in rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = shard.new_empty((n * shard.shape[0], *shard.shape[1:]))
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return torch.cat(out.view(n, *shard.shape).unbind(0), dim=dim)


def reduce_grads(grads: List[torch.Tensor], dims: List[Optional[int]], group
                 ) -> List[torch.Tensor]:
    """The ranks' gradients summed: a whole tensor where dims[i] is None (one
    all-reduce bucket a dtype), else this rank's shard along dims[i] (one
    reduce-scatter over a bucket that holds each rank's chunks in turn)."""
    import torch.distributed as dist

    out = list(grads)
    whole = [i for i, d in enumerate(dims) if d is None]
    for i, g in zip(whole, data_parallel.sum_tensors([grads[i] for i in whole], group)):
        out[i] = g
    cut = [i for i, d in enumerate(dims) if d is not None]
    if not cut:
        return out
    n = dist.get_world_size(group)
    for dtype in dict.fromkeys(grads[i].dtype for i in cut):
        idx = [i for i in cut if grads[i].dtype == dtype]
        parts = [grads[i].chunk(n, dims[i]) for i in idx]
        bucket = torch.cat([c[k].reshape(-1) for k in range(n) for c in parts])
        mine = bucket.new_empty(bucket.numel() // n)
        data_parallel.reduce_scatter(mine, bucket, group)
        at = 0
        for i, c in zip(idx, parts):
            out[i] = mine[at:at + c[0].numel()].view(c[0].shape)
            at += c[0].numel()
    return out


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sharded: Optional[List[bool]] = None, group=None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax.clip_by_global_norm (the JAX trainer's `clip_by_global_norm`
    chains it before the optimizer): the global norm sqrt(sum of each
    tensor's sum of squares), and each gradient as it is where the norm is
    below `max_norm`, else (g / norm) * max_norm. (`torch.nn.utils.
    clip_grad_norm_` scales by max_norm / (norm + 1e-6), another function.)
    `sharded[i]`: gradient i is this rank's shard of a tensor sharded over
    `group`, whose squares are summed across the ranks; the others are
    whole on every rank. Returns (clipped gradients, norm)."""
    sharded = sharded or [False] * len(grads)
    whole = sum(torch.sum(g * g) for g, s in zip(grads, sharded) if not s)
    if any(sharded):
        part = torch.stack([torch.sum(g * g) for g, s in zip(grads, sharded) if s]).sum()
        whole = whole + data_parallel.sum_tensors([part], group)[0]
    norm = torch.sqrt(torch.as_tensor(whole))
    trigger = norm < max_norm
    return [torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm) for g in grads], norm


@dataclass
class GANTrainState:
    """What a step reads and updates, in place. `netg`, `netgh` and `dnets`
    hold the float32 master parameters and the BN running stats; `a` is
    netGH's trained blend weight (params['a'] in JAX; the module's own `a`
    is a buffer, overridden by this one in every call), None under a weight
    map, whose maps are netGH parameters; `g_ema` the EMA of every G
    parameter by name ("netg.<param>", "netgh.<param>", "netgh.a").
    `mini_step` counts the micro-steps since the last update, `g_acc` /
    `d_acc` their running-mean gradients (grad_accum > 1 only)."""

    step: int
    netg: nn.Module
    netgh: nn.Module
    a: Optional[torch.Tensor]
    dnets: nn.ModuleDict
    g_ema: Dict[str, torch.Tensor]
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    mini_step: int = 0
    g_acc: List[torch.Tensor] = field(default_factory=list)
    d_acc: List[torch.Tensor] = field(default_factory=list)
    mesh: Any = None  # the trainer's mesh under --fsdp
    shards: Dict[str, int] = field(default_factory=dict)  # parameter -> its sharded dim
    group: Any = None  # the batch group the shards span

    def d_named_parameters(self) -> List[Tuple[str, torch.Tensor]]:
        return [(f"dnets.{n}", p) for n, p in self.dnets.named_parameters()]

    def _place(self, name: str, t: torch.Tensor):
        """A tensor of parameter `name`'s layout: a DTensor where it is
        stored sharded."""
        if name not in self.shards:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh, placements(self.mesh, self.shards[name]),
                                  run_check=False)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter `name`'s shard `t` (a collective
        where it is sharded; `t` itself otherwise)."""
        if name not in self.shards:
            return t
        return gather_dim(t, self.shards[name], self.group)

    def full_ema(self) -> Dict[str, torch.Tensor]:
        """The G EMA, every tensor whole (a collective under --fsdp)."""
        return {n: self.full(n, t) for n, t in self.g_ema.items()}

    def state_dict(self) -> Dict[str, Any]:
        """The whole train state (JAX's orbax tree), flat, for
        `checkpoints/dcp_io.py`: step and mini_step; netg, netgh and the
        dnets (parameters and BN stats) by name; the trained `a`; the G EMA
        (`g_ema.<name>`); both Adams' state by parameter name
        (`g_opt.<name>.step`, `.exp_avg`, `.exp_avg_sq`); the grad_accum
        buffers (`g_acc.<name>`, `d_acc.<name>`). The tensors are the live
        ones (a checkpoint restores into them in place), a sharded one as a
        DTensor of this rank's shard."""
        out: Dict[str, Any] = {"step": torch.tensor(self.step),
                               "mini_step": torch.tensor(self.mini_step)}
        for key, module in (("netg", self.netg), ("netgh", self.netgh), ("dnets", self.dnets)):
            for n, b in module.named_buffers():
                out[f"{key}.{n}"] = b
        g_named, d_named = self.g_named_parameters(), self.d_named_parameters()
        for name, p in g_named + d_named:
            out["a" if name == "netgh.a" else name] = self._place(name, p.data)
        for name, t in self.g_ema.items():
            out[f"g_ema.{name}"] = self._place(name, t)
        for tag, opt, named, acc in (("g", self.g_opt, g_named, self.g_acc),
                                     ("d", self.d_opt, d_named, self.d_acc)):
            for name, p in named:
                st = opt.state[p]
                out[f"{tag}_opt.{name}.step"] = st["step"]
                for k in ADAM_KEYS[1:]:
                    out[f"{tag}_opt.{name}.{k}"] = self._place(name, st[k])
            for (name, _), t in zip(named, acc):
                out[f"{tag}_acc.{name}"] = self._place(name, t)
        return out

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        """Copies a `state_dict()` (whole tensors, or DTensors of this
        layout) into the live state, in place."""
        from torch.distributed.tensor import DTensor

        mine = self.state_dict()
        missing = set(mine) - set(sd)
        if missing:
            raise KeyError(f"train state without {sorted(missing)[:4]}")
        with torch.no_grad():
            for k, t in mine.items():
                v = sd[k]
                if v is t:
                    continue
                local = t.to_local() if isinstance(t, DTensor) else t
                src = v.to_local() if isinstance(v, DTensor) else torch.as_tensor(v)
                if isinstance(t, DTensor) and not isinstance(v, DTensor):
                    src = local_shard(src, self.mesh, t.placements[0].dim)
                local.copy_(src)
        self.step = int(sd["step"])
        self.mini_step = int(sd["mini_step"])

    def g_named_parameters(self) -> List[Tuple[str, torch.Tensor]]:
        return ([(f"netg.{n}", p) for n, p in self.netg.named_parameters()]
                + [(f"netgh.{n}", p) for n, p in self.netgh.named_parameters()]
                + ([] if self.a is None else [("netgh.a", self.a)]))

    def g_state_dicts(self) -> Tuple[StateDict, StateDict, Optional[float]]:
        """(netg state dict, netgh state dict, a): the EMA parameters with
        the current BN running stats, on the CPU; a tied module's aliases
        (x16's h_net3, img_net2, ...) carry its EMA too. Under a weight map
        the maps' EMA is in the netgh state dict and a is None."""
        out = []
        ema = self.full_ema()
        for prefix, module in (("netg", self.netg), ("netgh", self.netgh)):
            sd = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
            first = {id(p): name for name, p in module.named_parameters()}
            for name, p in module.named_parameters(remove_duplicate=False):
                sd[name] = ema[f"{prefix}.{first[id(p)]}"].detach().cpu().clone()
            out.append(sd)
        return out[0], out[1], None if self.a is None else float(ema["netgh.a"])

    def snapshot_variables(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The (netG, netGH) flax trees a snapshot writes: the JAX trainer
        saves {'params': g_ema, 'batch_stats': g_stats} of each (a weight-map
        netGH's params: a1.., no 'a')."""
        netg_sd, netgh_sd, a = self.g_state_dicts()
        return netg_variables(netg_sd), netgh_variables(netgh_sd, a)


class GANTrainer:
    def __init__(self, cfg: Config, vocab_size: int, text_sd: Mapping[str, torch.Tensor],
                 image_encoder=None, compute_dtype: torch.dtype = torch.float32,
                 grad_accum: int = 1,
                 loss_weights: Optional[Mapping[str, float]] = None,
                 d_lr: Optional[float] = None, remat=False,
                 device: Union[str, torch.device] = "cuda", mesh=None, fsdp: bool = False,
                 clip_norm: Optional[float] = None):
        """`text_sd` the frozen text encoder's weights (a RNN_ENCODER state
        dict). `image_encoder`: a DAMSM `CNNEncoder` or `SimpleCNNEncoder`
        with its weights, frozen here, whose terms join adv (on the finest
        fake, 256 px at x8, 512 at x16). `loss_weights`
        scales the G terms 'adv', 'pixel' and 'kl', and 'damsm' the DAMSM
        terms inside adv (1.0 each); the metrics report the unweighted
        terms and 'g_loss' the weighted total. `remat`: JAX's policy, False /
        True / 'all' / 'low' / 'high' (ValueError with JAX's message
        otherwise). `device` is the card unless
        the caller asks for the CPU, where every kernel site runs its plain
        version. `mesh`: a `parallel.mesh` mesh, the batch this rank's rows
        of the global batch (data parallel; under a launcher `device` is this
        rank's card); `fsdp` (needs a mesh, JAX's message) the sharded
        storage. `clip_norm`: clip each optimizer's gradients to this global
        norm (`clip_by_global_norm`)."""
        check_trained(cfg)
        remat_policy(remat)
        if image_encoder is not None and not isinstance(image_encoder,
                                                        (CNNEncoder, SimpleCNNEncoder)):
            raise TypeError(f"image_encoder: a CNNEncoder or SimpleCNNEncoder module, not "
                            f"{type(image_encoder).__name__}")
        if fsdp and mesh is None:
            raise ValueError("fsdp=True requires a mesh")
        if fsdp and "dcn" in mesh.mesh_dim_names:
            raise ValueError("fsdp shards over a flat ('data', 'model') mesh's 'data' axis")
        if compute_dtype not in TRAIN_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: the port trains in {TRAIN_DTYPES}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum {grad_accum} must be at least 1")
        unknown = set(loss_weights or ()) - set(LOSS_TERMS)
        if unknown:
            raise ValueError(f"loss_weights {sorted(unknown)}: the terms are {LOSS_TERMS}")
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.device = resolve_device(device if mesh is None else device_of_rank(device))
        self.mesh = mesh
        self.fsdp = fsdp
        self.group = None if mesh is None else batch_group(mesh)
        self.clip_norm = clip_norm
        self.compute_dtype = compute_dtype
        # outputs, logits and losses: float32, or float64 for the reference
        self.loss_dtype = torch.promote_types(compute_dtype, torch.float32)
        self.grad_accum = grad_accum
        self.remat = remat
        self.batch_plan: Optional[Dict[str, Any]] = None  # plan_batch's last answer and probes
        self.loss_weights = dict(loss_weights or {})
        self.d_lr = cfg.TRAIN.DISCRIMINATOR_LR if d_lr is None else d_lr
        self.sizes = cfg.pyramid_sizes()
        self.text_encoder = TextEncoder(vocab_size, 300, cfg.TEXT.EMBEDDING_DIM,
                                        rnn_type=cfg.RNN_TYPE)
        self.text_encoder.load_state_dict(text_sd, strict=True)
        self.text_encoder.to(self.device).eval().requires_grad_(False)
        self.image_encoder = image_encoder
        if image_encoder is not None:
            image_encoder.to(self.device).eval().requires_grad_(False)
        s = cfg.TRAIN.SMOOTH
        self.gammas = (s.GAMMA1, s.GAMMA2, s.GAMMA3)

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> GANTrainState:
        """Fresh weights from `generator` (a CPU torch.Generator; JAX's
        PRNGKey stream cannot be reproduced, so tests carry JAX's init across
        with `load_state`), zero optimizer state, the EMA a copy."""
        cfg = self.cfg
        netg, netgh = make_generators(cfg, remat=self.remat)
        dnets = nn.ModuleDict({f"d{s}": DNet(ndf=cfg.GAN.DF_DIM, nef=cfg.TEXT.EMBEDDING_DIM,
                                             img_size=s) for s in self.sizes})
        for module in (netg, netgh, dnets):
            init_module(module, generator)
            module.to(self.device).train()
        a = (None if cfg.EVAL.WEIGHTMAP
             else torch.tensor(A_INIT, device=self.device, requires_grad=True))
        g_params = [*netg.parameters(), *netgh.parameters(), *([] if a is None else [a])]
        state = GANTrainState(
            step=0, netg=netg, netgh=netgh, a=a, dnets=dnets, g_ema={},
            g_opt=torch.optim.Adam(g_params, lr=self.cfg.TRAIN.GENERATOR_LR, betas=(0.5, 0.999)),
            d_opt=torch.optim.Adam(dnets.parameters(), lr=self.d_lr, betas=(0.5, 0.999)),
            mesh=self.mesh if self.fsdp else None, group=self.group)
        if self.fsdp:
            n = data_parallel.storage_shards(axis_sizes(self.mesh)["data"])
            with torch.no_grad():
                for name, p in state.g_named_parameters() + state.d_named_parameters():
                    dim = shard_dim(p.shape, n)
                    if dim is not None:
                        state.shards[name] = dim
                        p.data = local_shard(p.data, self.mesh, dim)
        # the optimizers' and grad_accum's state made now, as their first
        # update would make it, so that a fresh state is a checkpoint's
        # template (torch's Adam: a float32 step count on the CPU)
        for opt, params, acc in ((state.g_opt, g_params, state.g_acc),
                                 (state.d_opt, list(dnets.parameters()), state.d_acc)):
            for p in params:
                opt.state[p] = {"step": torch.tensor(0.0),
                                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                                "exp_avg_sq": torch.zeros_like(
                                    p, memory_format=torch.preserve_format)}
            if self.grad_accum > 1:
                acc.extend(torch.zeros_like(p) for p in params)
        self._reset_ema(state)
        return state

    def load_state(self, state: GANTrainState, netg_sd: Mapping[str, torch.Tensor],
                   netgh_sd: Mapping[str, torch.Tensor], a: Optional[float],
                   dnet_sds: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None) -> None:
        """Loads generator weights (reference-named state dicts, strict) and
        `a` into `state` (a weight map's maps come in netgh_sd, and `a` is
        not read), and the discriminators' ({"d64": sd, ...}) where given;
        the EMA restarts from the loaded weights (JAX's --init_netg). The
        optimizer state is left as it is. Under --fsdp a collective."""
        with self._whole(state), torch.no_grad():
            state.netg.load_state_dict(netg_sd, strict=True)
            state.netgh.load_state_dict(netgh_sd, strict=True)
            if state.a is not None:
                state.a.fill_(float(a))
            for name, sd in (dnet_sds or {}).items():
                state.dnets[name].load_state_dict(sd, strict=True)
        self._reset_ema(state)

    @staticmethod
    def _reset_ema(state: GANTrainState) -> None:
        state.g_ema = {n: p.detach().clone() for n, p in state.g_named_parameters()}

    # -- sharded storage (--fsdp) ----------------------------------------------------

    def _gather(self, state: GANTrainState, named) -> Dict[str, torch.Tensor]:
        """Each sharded parameter of `named` made whole (p.data the gathered
        tensor); returns its shard by name."""
        kept = {}
        for name, p in named:
            if name in state.shards:
                kept[name] = p.data
                p.data = gather_dim(p.data, state.shards[name], self.group)
        return kept

    @staticmethod
    def _release(named, kept: Mapping[str, torch.Tensor]) -> None:
        for name, p in named:
            if name in kept:
                p.data = kept[name]

    @contextmanager
    def _whole(self, state: GANTrainState):
        """Within: every parameter whole; after: each rank's shard taken
        back from the whole tensor, which the body may have changed."""
        named = state.g_named_parameters() + state.d_named_parameters()
        kept = self._gather(state, named)
        try:
            yield
        finally:
            with torch.no_grad():
                for name, p in named:
                    if name in kept:
                        kept[name].copy_(local_shard(p.data, self.mesh, state.shards[name]))
            self._release(named, kept)

    # -- the step -------------------------------------------------------------------

    def _inputs(self, batch: Mapping[str, Any]):
        dev = self.device
        captions = torch.as_tensor(batch["captions"], device=dev, dtype=torch.long)
        cap_lens = torch.as_tensor(batch["cap_lens"], device=dev, dtype=torch.long)
        with torch.no_grad():
            words, sent = self.text_encoder(captions, cap_lens)
        lr = nchw(torch.as_tensor(batch["lr"], device=dev, dtype=torch.float32))
        return lr, words, sent, captions == 0

    def _generate(self, state: GANTrainState, lr, words, sent, mask,
                  params: Optional[Mapping[str, torch.Tensor]] = None, buffers: bool = False):
        """netG then netGH in the compute dtype -> (fake, fine, mu, logvar)
        in the loss dtype, NCHW. `params` in place of the modules' own (the
        EMA)."""
        dt = self.compute_dtype
        lr_c = lr.to(dt)
        split = {k: {n[len(k) + 1:]: v for n, v in (params or {}).items()
                     if n.startswith(k + ".")} for k in ("netg", "netgh")}
        fake, _, mu, logvar = call_cast(state.netg, dt, lr_c, sent.to(dt), words.to(dt), mask,
                                        overrides=split["netg"], buffers=buffers)
        a = {} if state.a is None else {"a": state.a}
        fine = call_cast(state.netgh, dt, lr_c, fake, buffers=buffers,
                         overrides={**a, **split["netgh"]})
        lt = self.loss_dtype
        return [f.to(lt) for f in fake], [f.to(lt) for f in fine], mu.to(lt), logvar.to(lt)

    def _d_closures(self, dnet: DNet):
        """Train-mode D closures in the compute dtype; logits in the loss dtype."""
        dt, lt = self.compute_dtype, self.loss_dtype

        def d_feat(img):
            return call_cast(dnet, dt, img.to(dt), method="features")

        def d_cond(h, sent):
            return call_cast(dnet, dt, h, sent.to(dt), method="cond_logit").to(lt)

        def d_uncond(h):
            return call_cast(dnet, dt, h, method="uncond_logit").to(lt)

        return d_feat, d_cond, d_uncond

    def _encode(self, img: torch.Tensor):
        """The frozen image encoder on an NCHW fake in the loss dtype (eval
        BN; float64 casts its weights for the reference step); CNNEncoder's
        backbone frozen, as JAX's trainer applies it (freeze_backbone)."""
        return call_cast(self.image_encoder, self.loss_dtype, nhwc(img), buffers=True)

    def _apply(self, state: GANTrainState, opt, named, grads, acc: List[torch.Tensor]) -> bool:
        """The ranks' gradients summed (this rank's shard of each sharded
        one, the shards then put back in the parameters), clipped by
        `clip_norm`, then one optimizer update, or (grad_accum > 1) the
        running mean of the micro-steps' gradients as optax.MultiSteps keeps
        it, applied on the last micro-step. Returns whether the parameters
        moved."""
        names, params = [n for n, _ in named], [p for _, p in named]
        if self.group is not None:
            grads = reduce_grads(list(grads), [state.shards.get(n) for n in names], self.group)
        if self.clip_norm is not None:
            grads, _ = clip_by_global_norm(list(grads), self.clip_norm,
                                           [n in state.shards for n in names], self.group)
        mini_step = state.mini_step
        if self.grad_accum > 1:
            if not acc:
                acc.extend(torch.zeros_like(p) for p in params)
            for a, g in zip(acc, grads):
                a.add_((g - a) / (mini_step + 1))
            if mini_step != self.grad_accum - 1:
                return False
            grads = acc
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None
        for a in acc:
            a.zero_()
        return True

    @float32_math()
    def train_step(self, state: GANTrainState, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One D update, then one G update, in place. `batch`: 'lr' [B, b, b,
        3] and 'real_pyramid' (a list of [B, s, s, 3]), NHWC in [-1, 1] as
        `data.pipeline.device_preprocess` makes them, 'captions' [B, T],
        'cap_lens' [B] and, for the DAMSM terms, 'class_ids' [B] (optional).
        Returns the metrics (JAX's keys). Under a mesh the batch is this
        rank's rows of the global batch and the metrics the global batch's
        (summed over the ranks)."""
        with data_parallel.data_parallel(self.group):
            metrics = self._step(state, batch)
        if self.group is not None:
            keys = list(metrics)
            metrics = dict(zip(keys, data_parallel.sum_tensors([metrics[k] for k in keys],
                                                               self.group)))
        return metrics

    def _step(self, state: GANTrainState, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        g_named, d_named = state.g_named_parameters(), state.d_named_parameters()
        g_kept = self._gather(state, g_named)
        d_kept = self._gather(state, d_named)
        lr, words, sent, mask = self._inputs(batch)
        real = [nchw(torch.as_tensor(x, device=self.device, dtype=self.loss_dtype))
                for x in batch["real_pyramid"]]
        for module in (state.netg, state.netgh, state.dnets):
            module.train()
        fake, fine, mu, logvar = self._generate(state, lr, words, sent, mask)

        # D, on the detached fine pyramid (discriminator_loss detaches)
        d_params = [p for _, p in d_named]
        d_loss = 0.0
        for s, r, f in zip(self.sizes, real, fine):
            d_loss = d_loss + discriminator_loss(*self._d_closures(state.dnets[f"d{s}"]),
                                                 r, f, sent)
        d_grads = torch.autograd.grad(d_loss, d_params)
        self._release(d_named, d_kept)
        self._apply(state, state.d_opt, d_named, d_grads, state.d_acc)
        d_kept = self._gather(state, d_named)  # G steps against the updated D

        # G, against the updated D, through the same forward
        ds = [self._d_closures(state.dnets[f"d{s}"]) for s in self.sizes]
        lt = self.loss_dtype
        share = data_parallel.share(data_parallel.data_group())
        cap_lens = torch.as_tensor(batch["cap_lens"], device=self.device)
        class_ids = batch.get("class_ids")
        if class_ids is not None:
            class_ids = torch.as_tensor(class_ids, device=self.device)
        dw = self.loss_weights.get("damsm", 1.0)
        adv, logs = generator_loss(ds, self._encode if self.image_encoder is not None else None,
                                   fine, sent.to(lt), words.to(lt), cap_lens, class_ids,
                                   self.gammas, self.cfg.TRAIN.SMOOTH.LAMBDA, w=dw, s=dw)
        kl = kl_loss(mu, logvar)
        pix = mse_pyramid(fake, real) + mse_pyramid(fine, real)
        if data_parallel.data_group() is not None:  # this rank's part of the global means
            kl, pix = kl * share, pix * share
        w = self.loss_weights
        g_loss = w.get("adv", 1.0) * adv + w.get("kl", 1.0) * kl + w.get("pixel", 1.0) * pix
        names, g_params = zip(*g_named)
        g_grads = torch.autograd.grad(g_loss, g_params)
        self._release(g_named, g_kept)
        self._release(d_named, d_kept)
        applied = self._apply(state, state.g_opt, g_named, g_grads, state.g_acc)
        if applied:
            with torch.no_grad():
                d = EMA_DECAY
                for name, p in zip(names, g_params):
                    state.g_ema[name].mul_(d).add_(p * (1 - d))
        state.mini_step = (state.mini_step + 1) % self.grad_accum
        state.step += 1
        metrics = {"d_loss": d_loss, "g_loss": g_loss, **logs, "kl": kl, "pixel": pix,
                   "adv": adv}
        return {k: v.detach() for k, v in metrics.items()}

    def train_steps(self, state: GANTrainState, batches: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
        """K steps over a stacked batch (JAX's `train_steps`, :546): every
        leaf of `batches` (and each scale of 'real_pyramid') has a leading
        [K] axis. Bit for bit K `train_step` calls; returns the metrics
        stacked [K]. (JAX scans one compiled step; a captured step is the
        port's counterpart, ROADMAP A 8.)"""
        k = len(batches["captions"])
        steps = []
        for i in range(k):
            b = {key: ([x[i] for x in v] if key == "real_pyramid" else v[i])
                 for key, v in batches.items()}
            steps.append(self.train_step(state, b))
        return {key: torch.stack([m[key] for m in steps]) for key in steps[0]}

    # -- evaluation -------------------------------------------------------------------

    @torch.no_grad()
    @float32_math()
    def super_resolve(self, state: GANTrainState, batch: Mapping[str, Any]) -> torch.Tensor:
        """The generator chain in eval mode (EMA weights; BN on its running
        stats, nothing moves) on the batch's LR: the SR, the
        fine pyramid's top, NHWC [B, S, S, 3] (S 256 at x8, 512 at x16)."""
        lr, words, sent, mask = self._inputs(batch)
        state.netg.eval()
        state.netgh.eval()
        try:
            _, fine, _, _ = self._generate(state, lr, words, sent, mask,
                                           params=state.full_ema(), buffers=True)
        finally:
            state.netg.train()
            state.netgh.train()
        return nhwc(fine[-1])

    def eval_metrics(self, state: GANTrainState,
                     batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Eval-mode quality of the generator chain (`super_resolve`): mean
        Y-channel PSNR (BT.601) and SSIM of G(LR) against the batch's pyramid
        top, the reference metric (trainer_objective.py:168-181)."""
        sr8 = denormalize_to_uint8(self.super_resolve(state, batch))
        gt8 = denormalize_to_uint8(torch.as_tensor(batch["real_pyramid"][-1], device=self.device,
                                                   dtype=torch.float32))
        y_sr = rgb2y(sr8).float()[..., None]
        y_gt = rgb2y(gt8).float()[..., None]
        return {"psnr_y": psnr_batch(y_sr, y_gt).mean(), "ssim_y": ssim(y_sr, y_gt).mean()}

    # -- capacity planning ----------------------------------------------------------------

    def _probe_batch(self, b: int) -> Dict[str, torch.Tensor]:
        """A batch of b noise images on the device, full-length captions."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        dev, t = self.device, self.cfg.TEXT.WORDS_NUM
        u = lambda s: torch.rand(b, s, s, 3, generator=gen, device=dev) * 2 - 1
        return {"lr": u(self.cfg.TREE.BASE_SIZE), "real_pyramid": [u(s) for s in self.sizes],
                "captions": torch.randint(1, self.vocab_size, (b, t), generator=gen, device=dev),
                "cap_lens": torch.full((b,), t, device=dev),
                "class_ids": torch.arange(b, device=dev)}

    def step_peak_bytes(self, b: int, budget_bytes: int) -> Optional[int]:
        """What a fresh run at batch b needs on the card: the peak of the
        bytes the caching allocator reserves, above what it held before, for
        a fresh state and two steps on noise images (the second with Adam's
        moments resident), with the allocator capped at `budget_bytes` more
        than it held (`utils.memory.reserved_cap`). Uncapped, cuDNN takes
        larger workspaces where more memory is free, so a step's peak depends
        on the card's state (x16 float32 at B = 32 peaked at 64.25 and at
        75.24 GiB on one H100); capped, a run that completes fits. None
        where the run runs out of memory under the cap. `plan_batch`'s
        probe."""
        def run() -> None:
            with memory.reserved_cap(self.device, budget_bytes):
                state = self.init_state(torch.Generator().manual_seed(0))
                batch = self._probe_batch(b)
                for _ in range(2):
                    self.train_step(state, batch)

        try:
            return memory.peak_bytes(run, self.device)
        except torch.cuda.OutOfMemoryError:
            return None
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    def plan_batch(self, budget_bytes: Optional[int] = None, lo: int = 8, hi: int = 1024,
                   quantum: int = 8) -> int:
        """The largest training batch in [lo, hi], lo or a multiple of
        `quantum`, whose D + G step fits `budget_bytes` (default
        `utils.memory.device_memory_budget`: 0.9 of the device memory free
        now) under this trainer's remat policy, compute dtype and DAMSM
        terms; 0 where `lo` does not fit. The counterpart of JAX's
        (tgsr_tpu/engine/gan_trainer.py:572-615), which bisects XLA's
        compile-time memory: the port bisects runs. A probe builds a fresh
        state on the card and takes two steps on noise images with the
        allocator capped at the budget (`step_peak_bytes`); a batch fits
        where two such runs in a row complete: the first run at a new batch
        size searches cuDNN's algorithms under the cap, and a later run can
        then need more (a narrow x16 tree at B = 32 peaked at 1020 MiB of a
        1024 MiB cap in its first run and ran out of memory in each of three
        more, on one H100). lo is measured first, then the candidates above
        it by bisection (8 probes for [8, 1024]). What the caller holds on
        the card already counts against the free memory. Records each
        probe's larger peak (None: out of memory) in `self.batch_plan`.
        Raises ValueError on the
        CPU, whose peak the port cannot measure (JAX answers there when
        given `budget_bytes`: a deliberate difference, ROADMAP Queue C)."""
        dev = self.device
        if dev.type != "cuda":
            raise ValueError(f"plan_batch measures a step's peak memory on a CUDA device; "
                             f"the trainer is on {dev}, whose memory the port cannot measure")
        lo, quantum = max(1, lo), max(1, quantum)
        if budget_bytes is None:
            gc.collect()
            torch.cuda.empty_cache()
            budget_bytes = memory.device_memory_budget(dev)
        probes: Dict[int, Optional[int]] = {}

        def fits(b: int) -> bool:
            first = self.step_peak_bytes(b, budget_bytes)
            second = None if first is None else self.step_peak_bytes(b, budget_bytes)
            probes[b] = None if second is None else max(first, second)
            return probes[b] is not None

        candidates = [lo] + list(range((lo // quantum + 1) * quantum, hi + 1, quantum))
        good, bad = (0, len(candidates)) if fits(lo) else (-1, 0)
        while bad - good > 1:  # candidates[good] fits, candidates[bad] does not
            mid = (good + bad) // 2
            good, bad = (mid, bad) if fits(candidates[mid]) else (good, mid)
        best = candidates[good] if good >= 0 else 0
        self.batch_plan = {"batch": best, "budget_bytes": budget_bytes, "probes": probes}
        return best
