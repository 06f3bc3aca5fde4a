"""Pipeline parallelism: GPipe microbatches through a homogeneous chain of
blocks split over ranks (counterpart of tgsr_tpu/parallel/pipeline.py).

The JAX package stacks the chain's variables on a leading axis sharded over
a 'stage' mesh axis and runs the rotating schedule in `shard_map`, handing
activations on with `ppermute`. Here one process per device is one stage:
stage s holds blocks [s n / S, (s + 1) n / S) of the n stacked blocks and
applies them in order; microbatch m enters stage 0 at step m, and each stage
receives its input from the stage before (`recv`) and sends its output to
the one after (`isend`), so after the S - 1 steps of the fill every stage
works on another microbatch. The last stage's outputs are broadcast to every
rank of the stage mesh, as JAX's `psum` gives them to every device.

Eval mode only: with BatchNorm on its running statistics microbatching is
exactly the unsplit forward, as JAX's docstring says. No entry point calls
it (none does in JAX); tests/test_torch_pipeline_parallel.py runs it on
NetGHighWeight's residual.0..5.

On gloo a CUDA activation is staged through host memory.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from tgsr_tpu_torch.parallel.multihost import host_staged, process_count

StateDict = Dict[str, torch.Tensor]


def stack_block_variables(vars_list: Sequence[Mapping[str, torch.Tensor]]) -> StateDict:
    """N state dicts of one structure -> one dict of tensors stacked on a
    new leading axis (a homogeneous chain, e.g. N ResBlocks of one width)."""
    keys = set(vars_list[0])
    if any(set(v) != keys for v in vars_list):
        raise ValueError("stack_block_variables: the blocks' state dicts differ in their keys")
    return {k: torch.stack([v[k] for v in vars_list]) for k in vars_list[0]}


def extract_chain(module: nn.Module, names: Sequence[str]) -> StateDict:
    """The named submodules of `module` (chain order, e.g. residual.0 ..
    residual.5 of NetGHighWeight), their parameters and buffers stacked."""
    return stack_block_variables([module.get_submodule(n).state_dict() for n in names])


def make_stage_mesh(n_stages: int, device: str = "cuda"):
    """A one-axis ('stage',) DeviceMesh over the first `n_stages` ranks of
    the process group (every rank calls it; the others are not on it)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = process_count()
    if n_stages > world:
        raise ValueError(f"pipeline needs {n_stages} devices, have {world}")
    return DeviceMesh(torch.device(device).type, torch.arange(n_stages),
                      mesh_dim_names=("stage",))


def pipeline_apply(block_fn: Callable[[StateDict, torch.Tensor], torch.Tensor],
                   stacked_vars: Mapping[str, torch.Tensor], x: torch.Tensor, mesh,
                   n_micro: int, axis: str = "stage") -> torch.Tensor:
    """x through the stacked chain, pipelined over the ranks of `mesh[axis]`:
    block_{n-1}(...block_0(x)).

    block_fn(one_block_vars, h) -> h applies one block (shape-preserving),
    e.g. `torch.func.functional_call(block, vars, (h,))` on a block in eval
    mode. `stacked_vars` leaves are [n_blocks, ...] (`extract_chain`); each
    of the S stages applies its n_blocks / S consecutive blocks. x [B, ...]
    is the whole batch on every rank of the mesh, split into `n_micro`
    microbatches. Every rank of the mesh returns the whole result. Call it
    on the mesh's ranks alone."""
    n_blocks = next(iter(stacked_vars.values())).shape[0]
    stages = mesh.size(mesh.mesh_dim_names.index(axis))
    if n_blocks % stages:
        raise ValueError(f"{n_blocks} blocks do not split over {stages} stages")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    group = mesh.get_group(axis)
    stage = dist.get_rank(group)
    if stage < 0:
        raise ValueError("pipeline_apply: this rank is not on the stage mesh")
    per = n_blocks // stages
    blocks = [{k: v[stage * per + i] for k, v in stacked_vars.items()} for i in range(per)]
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    staged = host_staged(x, group)
    peer = (lambda s: dist.get_global_rank(group, s))
    outs, sends = [], []
    for t in range(n_micro + stages - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue
        if stage == 0:
            h = micro[m]
        else:
            buf = torch.empty_like(micro[m], device="cpu" if staged else x.device)
            dist.recv(buf, peer(stage - 1), group=group)
            h = buf.to(x.device)
        for vars_ in blocks:
            h = block_fn(vars_, h)
        if stage < stages - 1:
            wire = (h.cpu() if staged else h).contiguous()
            sends.append((dist.isend(wire, peer(stage + 1), group=group), wire))
        else:
            outs.append(h)
    for req, _ in sends:
        req.wait()
    out = torch.cat(outs) if stage == stages - 1 else torch.empty_like(x)
    if stages > 1:
        wire = (out.cpu() if staged else out).contiguous()
        dist.broadcast(wire, peer(stages - 1), group=group)
        out = wire.to(x.device)
    return out.reshape(x.shape)
