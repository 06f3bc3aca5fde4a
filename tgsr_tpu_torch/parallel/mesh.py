"""Device meshes and the layouts of a data-parallel or sharded state
(counterpart of tgsr_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the process
group, one rank per GPU: ('data', 'model') from `make_mesh`, or ('dcn',
'data', 'model') from `make_hybrid_mesh` (dcn = the node). The batch shards
over the batch axes ('data', and 'dcn' before it on a hybrid mesh): rank r of
a flat DATAxMODEL mesh takes data shard r // MODEL. A 'model' axis above 1
replicates the step over its ranks, as JAX's step does for a model axis it
does not partition.

The `--fsdp` layout (`fsdp_spec`) is JAX's: each leaf sharded over 'data'
along its largest divisible dimension, replicated under 1024 elements or
where no dimension divides. It is storage only: the trainer all-gathers a
parameter before the step and reduce-scatters its gradient, so the layout
never changes the math.

JAX's `fast_forward_key` has no counterpart: the port's steps draw no
per-step key (CANet's c_code feeds nothing on the SR path and is not drawn;
DAMSM's dropout is seeded by the global step, `DAMSMTrainer.
dropout_generator`), so a resumed run needs no key to be replayed.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tgsr_tpu_torch.parallel.multihost import initialize_single, process_count

FSDP_MIN_ELEMENTS = 1024
# a hybrid mesh -> its ('dcn', 'data') group, dropped with the mesh
_BATCH_GROUPS: "weakref.WeakKeyDictionary[Any, Any]" = weakref.WeakKeyDictionary()


def parse_mesh_arg(spec: str) -> Tuple[int, int]:
    """A CLI mesh spec 'DATAxMODEL' (e.g. '8x1') -> (n_data, n_model).
    ValueError on anything else (the CLIs turn it into a parser.error)."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(spec)
    n_data, n_model = (int(t) for t in parts)
    if n_data < 1 or n_model < 1:
        raise ValueError(spec)
    return n_data, n_model


def _world(n: int, device: str) -> int:
    """The process group's size; a 1-rank mesh without a launcher starts a
    group of this process alone."""
    if not dist.is_initialized() and n == 1:
        initialize_single(device)
    return process_count()


def _check_size(shape: Sequence[int], device: str) -> None:
    n = int(np.prod(shape))
    world = _world(n, device)
    name = "x".join(map(str, shape))
    if n > world:
        raise ValueError(f"mesh {name} needs more than {world} devices: one process per GPU, "
                         f"launch {n} ranks (torchrun --nproc_per_node {n} -m ...)")
    if n < world:
        raise ValueError(f"mesh {name} covers {n} of the process group's {world} ranks; "
                         f"launch {n} (torchrun --nproc_per_node {n} -m ...)")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device: str = "cuda"):
    """('data', 'model') mesh over the process group (n_data defaults to the
    world over n_model). Its size must be the group's: one rank per device.
    A 1x1 mesh in a single process without a launcher starts a group of one,
    as JAX's 1x1 mesh on one chip."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_data is None:
        n_data = max(process_count() // n_model, 1)
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: both axes must be at least 1")
    _check_size((n_data, n_model), device)
    return init_device_mesh(torch.device(device).type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def make_hybrid_mesh(n_slices: int, n_data: Optional[int] = None, n_model: int = 1,
                     device: str = "cuda"):
    """('dcn', 'data', 'model') mesh: 'dcn' enumerates nodes (torchrun's
    ranks are node-major, so row-major order puts a node's ranks together),
    the batch shards over ('dcn', 'data') and 'model' stays within a node.
    JAX's message where the group is too small."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_data is None:
        n_data = max(process_count() // (n_slices * n_model), 1)
    need = n_slices * n_data * n_model
    world = _world(need, device)
    if n_slices < 1 or n_data < 1 or n_model < 1 or need > world:
        raise ValueError(f"hybrid mesh {n_slices}x{n_data}x{n_model} needs {need} devices, "
                         f"have {world}")
    _check_size((n_slices, n_data, n_model), device)
    mesh = init_device_mesh(torch.device(device).type, (n_slices, n_data, n_model),
                            mesh_dim_names=("dcn", "data", "model"))
    # the batch group: the ranks of one model index, node-major (every rank
    # creates every group, in the same order)
    grid = mesh.mesh.reshape(n_slices * n_data, n_model)
    for m in range(n_model):
        group = dist.new_group([int(r) for r in grid[:, m]])
        if dist.get_rank() in grid[:, m].tolist():
            _BATCH_GROUPS[mesh] = group
    return mesh


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """('dcn', 'data') on a hybrid mesh, ('data',) on a flat one."""
    return tuple(a for a in ("dcn", "data") if a in mesh.mesh_dim_names) or ("data",)


def batch_shards(mesh) -> int:
    """How many ways the batch shards on `mesh`: the product of its batch
    axes (the divisibility a DP batch needs)."""
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in batch_axes(mesh)]))


def data_index(mesh) -> int:
    """This rank's data shard: its coordinate over the batch axes,
    node-major."""
    index = 0
    sizes = axis_sizes(mesh)
    for a in batch_axes(mesh):
        index = index * sizes[a] + mesh.get_local_rank(a)
    return index


def batch_group(mesh):
    """The process group over which a step's batch is sharded (its gradients
    and batch statistics reduce over it): the 'data' group, or the ('dcn',
    'data') group of a hybrid mesh."""
    if "dcn" in mesh.mesh_dim_names:
        return _BATCH_GROUPS[mesh]
    return mesh.get_group("data")


def shard_batch(tree: Any, mesh, device: Optional[torch.device] = None) -> Any:
    """This rank's rows of a global batch (`multihost.land_batch`), tensors
    moved to `device` where given; 0-d leaves replicate."""
    from tgsr_tpu_torch.parallel.multihost import land_batch

    rows = land_batch(tree, mesh)
    if device is None:
        return rows

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(device)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x

    return move(rows)


def replicate(tree: Any, mesh=None) -> Any:
    """Every tensor of `tree` made rank 0's on every rank (a broadcast, in
    place), as JAX's replicated placement; returns the tree."""
    if not dist.is_initialized() or process_count() == 1:
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            dist.broadcast(tree.data, src=0)
    return tree


def fsdp_spec(shape: Sequence[int], n_shards: int, axis_name: str = "data",
              min_elements: int = FSDP_MIN_ELEMENTS) -> Tuple[Optional[str], ...]:
    """JAX's `fsdp_spec` as a tuple (JAX's PartitionSpec is one): `axis_name`
    at the largest dimension divisible by `n_shards`, None elsewhere; () (a
    replicated leaf) for a leaf under `min_elements` or with no divisible
    dimension."""
    shape = tuple(shape)
    if n_shards <= 1 or int(np.prod(shape, dtype=np.int64)) < min_elements:
        return ()
    best = None
    for d, n in enumerate(shape):
        if n % n_shards == 0 and (best is None or n > shape[best]):
            best = d
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis_name
    return tuple(spec)


def shard_dim(shape: Sequence[int], n_shards: int,
              min_elements: int = FSDP_MIN_ELEMENTS) -> Optional[int]:
    """The dimension `fsdp_spec` shards, or None for a replicated leaf."""
    spec = fsdp_spec(shape, n_shards, "data", min_elements)
    return spec.index("data") if spec else None


def placements(mesh, dim: Optional[int]):
    """The DTensor placements of a leaf sharded at `dim` over 'data' (None:
    replicated) on `mesh`, replicated over every other axis."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dim) if (a == "data" and dim is not None) else Replicate()
            for a in mesh.mesh_dim_names]


def fsdp_shardings(tree: Dict[str, torch.Tensor], mesh,
                   min_elements: int = FSDP_MIN_ELEMENTS) -> Dict[str, list]:
    """Per-leaf DTensor placements of the FSDP layout over 'data' (see
    `fsdp_spec`)."""
    n = axis_sizes(mesh)["data"]
    return {k: placements(mesh, shard_dim(v.shape, n, min_elements)) for k, v in tree.items()}


def local_shard(x: torch.Tensor, mesh, dim: Optional[int]) -> torch.Tensor:
    """This rank's chunk of a full tensor at `dim` over 'data' (a copy), or
    the tensor itself where it is replicated."""
    if dim is None:
        return x
    n = axis_sizes(mesh)["data"]
    return x.chunk(n, dim)[mesh.get_local_rank("data")].clone()


def fsdp_state(tree: Dict[str, torch.Tensor], mesh,
               min_elements: int = FSDP_MIN_ELEMENTS) -> Dict[str, Any]:
    """A flat state of full tensors placed in the FSDP layout: sharded leaves
    as DTensors holding this rank's chunk, small ones as they are."""
    from torch.distributed.tensor import DTensor

    n = axis_sizes(mesh)["data"]
    out = {}
    for k, v in tree.items():
        dim = shard_dim(v.shape, n, min_elements)
        out[k] = v if dim is None else DTensor.from_local(
            local_shard(v, mesh, dim), mesh, placements(mesh, dim), run_check=False)
    return out


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad a host batch so it divides the data axis (edge rows); returns
    (padded, n_real)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode="edge"), n
