"""Train-state checkpoints with resume (counterpart of
tgsr_tpu/checkpoints/orbax_io.py: `save_train_state`, `restore_train_state`,
`latest_step`, `TrainCheckpointer`), through torch.distributed.checkpoint
(DCP).

A train state is a flat dict of tensors (`GANTrainState.state_dict()`), a
leaf stored sharded across ranks a DTensor: every rank writes its own shards
and one copy of what is replicated, and a restore reads, onto the template's
layout, the parts each rank needs. A checkpoint written at one world size
restores at another (JAX's "topology-portable"). Steps live in
`<directory>/<step>/`; a step counts once its `.metadata` (written last, by
the coordinator) is there, and only the newest `max_to_keep` are kept.
Saving and restoring are collectives of every rank of the process group,
when there is one.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

METADATA = ".metadata"


def host_copy(state: Dict[str, Any]) -> Dict[str, Any]:
    """A state dict whose host tensors the training steps cannot change: a
    tensor in host memory (or a DTensor's shard there) is cloned; one on a
    card is left to DCP's staging, which copies it to host memory before
    `async_save` returns."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k, t in state.items():
        if isinstance(t, DTensor) and not t.to_local().is_cuda:
            out[k] = DTensor.from_local(t.to_local().detach().clone(), t.device_mesh,
                                        t.placements, run_check=False)
        elif isinstance(t, torch.Tensor) and not isinstance(t, DTensor) and not t.is_cuda:
            out[k] = t.detach().clone()
        else:
            out[k] = t
    return out


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(int(step)))


def all_steps(directory: str):
    """The committed steps under `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, METADATA)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _prune(directory: str, max_to_keep: int) -> None:
    """Rank 0 removes committed steps beyond the newest `max_to_keep`."""
    if not _is_coordinator() or not max_to_keep:
        return
    for step in all_steps(directory)[:-max_to_keep]:
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)


def save_train_state(directory: str, step: int, state: Dict[str, Any], max_to_keep: int = 3,
                     process_group=None) -> None:
    """Writes `state` (a state dict) as step `step`, blocking, then prunes."""
    import torch.distributed.checkpoint as dcp

    path = _step_dir(directory, step)
    if os.path.exists(os.path.join(path, METADATA)):
        raise ValueError(f"checkpoint step {step} already exists in {directory}")
    dcp.save(state, checkpoint_id=path, process_group=process_group)
    _prune(directory, max_to_keep)


def restore_train_state(directory: str, template: Dict[str, Any], step: Optional[int] = None,
                        process_group=None) -> tuple:
    """(state, step): `template` (a state dict of the layout to restore onto,
    such as a fresh state's; its tensors are filled in place) loaded from
    step `step`, or the latest. FileNotFoundError where there is none."""
    import torch.distributed.checkpoint as dcp

    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    dcp.load(template, checkpoint_id=_step_dir(directory, step), process_group=process_group)
    return template, step


class TrainCheckpointer:
    """A persistent asynchronous checkpoint writer for training loops.

    `save()` returns after the state's device-to-host copy (DCP's
    `async_save` stages the card's tensors, `host_copy` clones the host's:
    the steps update the state in place), and the write runs in a background
    thread while the next steps run. A save in flight is joined
    before the next one starts. Under a process group the background
    collectives run on a gloo group of their own, so that they never
    interleave with the step's NCCL collectives. Use as a context manager;
    `close()` joins the pending write."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._pending = None
        self._pending_step = None
        self.group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        if _is_coordinator():
            os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Async save; returns after the device-to-host copy."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        path = _step_dir(self.directory, step)
        if os.path.exists(os.path.join(path, METADATA)):
            raise ValueError(f"checkpoint step {step} already exists in {self.directory}")
        self._pending = dcp.async_save(host_copy(state), checkpoint_id=path,
                                       process_group=self.group)
        self._pending_step = int(step)

    def restore(self, template: Dict[str, Any], step: Optional[int] = None) -> tuple:
        self.wait()
        return restore_train_state(self.directory, template, step, process_group=self.group)

    def latest_step(self) -> Optional[int]:
        """The newest step saved, or being saved."""
        if self._pending is not None:
            return self._pending_step
        return latest_step(self.directory)

    def wait(self) -> None:
        """Blocks until the queued write is committed, then prunes."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
            _prune(self.directory, self.max_to_keep)

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
