"""Multi-process helpers (counterpart of tgsr_tpu/parallel/multihost.py).

JAX runs one process per host and a mesh over every host's devices; the port
runs one process per GPU under `torchrun`, each rank bound to
`cuda:LOCAL_RANK`, joined by `torch.distributed` (NCCL on the card, gloo on
the CPU). Every rank replays the same deterministic host stream and takes
its own rows of each global batch (`process_local_slice`, `land_batch`), the
JAX CLIs' multi-process convention. Everything here degenerates to a no-op
in a single process without a launcher.
"""

from __future__ import annotations

import os
import socket
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True when a launcher (torchrun, or a caller that sets its variables)
    describes a process group in the environment."""
    return all(v in os.environ for v in LAUNCHER_VARS)


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(device: str = "cuda") -> int:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT); returns this
    process's rank. NCCL for a `cuda` device, gloo for `cpu`; rank r binds to
    `cuda:LOCAL_RANK`. A no-op returning 0 without a launcher (so the CLIs
    call it unconditionally) and when the group is already up."""
    if dist.is_initialized():
        return dist.get_rank()
    if not launched():
        return 0
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(dev), rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_single(device: str = "cuda") -> None:
    """A process group of this process alone (tcp://localhost, a free port):
    what a 1x1 mesh runs on without a launcher, as JAX's 1x1 mesh on one
    chip."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend_for(torch.device(device)),
                            init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)


def host_staged(x: torch.Tensor, group) -> bool:
    """True where `group`'s backend takes no CUDA tensor (gloo, as on the
    CPU or for two ranks sharing one card): the tensor then crosses through
    host memory."""
    return x.is_cuda and "nccl" not in str(dist.get_backend(group))


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x (the same shape on each), concatenated along `dim` in
    the group's rank order, on every rank (through host memory on gloo)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    staged = host_staged(x, group)
    wire = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if staged else out


def all_reduce_min(value: int, group) -> int:
    """The least of every rank's integer `value` over `group`, on every rank
    (on the current card for NCCL, on the host otherwise)."""
    if dist.get_world_size(group) == 1:
        return value
    nccl = "nccl" in str(dist.get_backend(group))
    t = torch.tensor([value], dtype=torch.int64, device="cuda" if nccl else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())


def device_of_rank(device: str = "cuda") -> torch.device:
    """The device this rank drives: `cuda:LOCAL_RANK` under a launcher (one
    process per GPU), `device` as given otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and launched():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device_count() -> int:
    """The devices this process drives: one GPU a rank under a launcher
    (JAX's process drives every device of its host), else every visible
    card, or 1 on the CPU."""
    if launched():
        return 1
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1


def is_main_process() -> bool:
    """True on the rank that performs the host-side singleton writes
    (snapshots, metric logs, prints): rank 0, or the only process."""
    return process_index() == 0


def process_local_slice(n_global: int, mesh=None) -> slice:
    """This rank's contiguous rows of a global batch of `n_global`: its data
    shard (rank r of a DATAxMODEL mesh takes shard r // MODEL; the ranks of
    one model group share it), or its rank's share of the world without a
    mesh. n_global must divide by the number of shards."""
    if mesh is not None:
        from tgsr_tpu_torch.parallel.mesh import batch_shards, data_index

        shards, index = batch_shards(mesh), data_index(mesh)
    else:
        shards, index = process_count(), process_index()
    assert n_global % shards == 0, (n_global, shards)
    per = n_global // shards
    return slice(index * per, (index + 1) * per)


def _is_meta(x) -> bool:
    """A host-side metadata list (prepare_batch's "keys")."""
    return isinstance(x, list) and bool(x) and isinstance(x[0], str)


def land_batch(host_batch: Any, mesh=None) -> Any:
    """This rank's rows of a global host batch (every rank holds the same
    one: the deterministic loader's stream), leaf by leaf: arrays and
    tensors with a leading batch axis and metadata lists are sliced, 0-d
    leaves and anything else pass through. JAX's `land_batch` /
    `global_batch_from_local` assemble a global array from these rows; a
    rank of the port keeps only its own."""
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (list, tuple)) and not _is_meta(tree):
            for v in tree:
                yield from leaves(v)
        elif _is_meta(tree) or np.ndim(tree):
            yield tree

    dims = {len(x) for x in leaves(host_batch)}
    if not dims:
        return host_batch
    assert len(dims) == 1, f"mixed leading dims {dims}"
    sl = process_local_slice(dims.pop(), mesh)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if _is_meta(x):
            return x[sl]
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
            return x[sl]
        return x

    return one(host_batch)


def fetch_to_host(tree: Any) -> Any:
    """Full CPU copies on every rank, leaf by leaf, including leaves stored
    sharded across ranks (a DTensor of the `--fsdp` layout is all-gathered).
    A collective where any leaf is sharded: every rank calls it, then
    typically only `is_main_process()` writes the result."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: fetch_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_to_host(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree
