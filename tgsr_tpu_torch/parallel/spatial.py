"""The serving forward with the image height split over ranks (the port's
form of tgsr_tpu/engine/inference.py `sr_spatial`, where XLA's SPMD
partitioner inserts the halo exchanges; PyTorch has none, so they are here).

Rank r of the mesh's 'data' axis holds rows [r L, (r + 1) L) of every
activation (L = the rows of its level over the shards). An op with a
vertical receptive field of `halo` rows runs on its rows extended by the
`halo` rows above and below that its neighbours hold (`RowShards.extend`,
point-to-point sends and receives; a halo wider than one shard takes rows
from as many ranks as it needs), with its own padding, and the rows the
halo spoils are cropped (`RowShards.apply`). At the image's true top and
bottom nothing is added, so the op keeps its own padding there: zeros for
the convolutions, edge rows for the blur. Each module of the port that
reads across rows declares its halo as `row_halo` (and `NetGHighWeight`
its input's as `low_input_halo`); torch's `Conv2d` is read from its
kernel; a module that declares none and holds a 4-D weight or buffer
raises. The ops and their halos, in source rows of the op's input:

- a convolution k x k (stride 1, SAME): k // 2 (the int8 `QuantConv` too);
- an UpBlock (upsample, conv3x3; float, fused or int8, by phases too): 1,
  its output cropped by 2 rows a side;
- an int8 ResBlock (`QuantResBlock`: conv1, GLU, conv2 in three kernels):
  2; a float ResBlock's convs take 1 each;
- an up-head site (upsample, conv3x3, head k x k): ceil((1 + k // 2) / 2),
  1 for the 3x3 head, 2 for the 5x5 one; its srb and weight map are padded
  with zero rows there, which only the cropped rows read;
- the HF branch's blur (EVAL.INPUT_NETGH 'lrblur', 'lr-lrblur'): the
  gaussian's half support, 4 rows.

The word-pixel attention, BN, GLU, the activations and the blend are
pixel-local; the text encoder and CA_NET take no image, and run whole on
every rank. No op of the forward reduces over rows, so no other collective
is needed. The weight maps of EVAL.WEIGHTMAP are sliced to each rank's rows.

On gloo (the CPU, or two ranks sharing one card) a CUDA tensor is staged
through host memory for every exchange and gather; NCCL takes it as it is.
"""

from __future__ import annotations

import copy
import itertools
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tgsr_tpu_torch.parallel.multihost import all_gather_cat, host_staged


def _crop(y: torch.Tensor, top: int, bottom: int, dim: int = 2) -> torch.Tensor:
    if top == bottom == 0:
        return y
    return y.narrow(dim, top, y.shape[dim] - top - bottom).clone(
        memory_format=torch.preserve_format)


class RowShards:
    """The 'data' axis of a mesh as row shards of an image: this rank's
    index and the exchanges between the ranks."""

    def __init__(self, mesh, device: torch.device):
        self.group = mesh.get_group("data")
        self.n = dist.get_world_size(self.group)
        self.index = dist.get_rank(self.group)
        self.device = device

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a whole tensor along `dim`."""
        if x.shape[dim] % self.n:
            raise ValueError(f"sr_spatial: the image height {x.shape[dim]} does not divide "
                             f"over {self.n} shards")
        per = x.shape[dim] // self.n
        return x.narrow(dim, self.index * per, per)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's rows along `dim`."""
        return all_gather_cat(x, self.group, dim)

    def extend(self, x: torch.Tensor, halo: int, dim: int = 2) -> Tuple[torch.Tensor, int, int]:
        """x (this rank's rows along `dim`) with up to `halo` rows of the
        ranks above and below -> (x extended, rows added on top, rows added
        below); none beyond the image's true top and bottom."""
        n, r, rows = self.n, self.index, x.shape[dim]
        if n == 1 or halo == 0:
            return x, 0, 0
        staged = host_staged(x, self.group)
        ops, above, below = [], [], []
        for k in range(1, n):
            # rank r - k's last rows fall in my top halo; my first rows in its bottom one
            for peer, mine_first in ((r - k, True), (r + k, False)):
                if not 0 <= peer < n:
                    continue
                count = max(0, min(rows, halo - (k - 1) * rows))
                if count == 0:
                    continue
                start = 0 if mine_first else rows - count
                send = x.narrow(dim, start, count).contiguous()
                send = send.cpu() if staged else send
                recv = torch.empty_like(send)
                gpeer = dist.get_global_rank(self.group, peer)
                ops += [dist.P2POp(dist.isend, send, gpeer, self.group),
                        dist.P2POp(dist.irecv, recv, gpeer, self.group)]
                (above if peer < r else below).append((peer, recv))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        tops = [t.to(x.device) for _, t in sorted(above, key=lambda p: p[0])]
        bottoms = [t.to(x.device) for _, t in sorted(below, key=lambda p: p[0])]
        top = sum(t.shape[dim] for t in tops)
        bottom = sum(t.shape[dim] for t in bottoms)
        return torch.cat([*tops, x, *bottoms], dim), top, bottom

    def apply(self, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, halo: int,
              scale: int = 1) -> torch.Tensor:
        """fn on x's rows extended by `halo` (NCHW rows), its output (`scale`
        rows a row of x) cropped back to x's rows."""
        ext, top, bottom = self.extend(x, halo)
        return _crop(fn(ext), top * scale, bottom * scale)


class Halo(nn.Module):
    """A module run on its input's rows extended by `halo`, its output
    cropped (`RowShards.apply`)."""

    def __init__(self, inner: nn.Module, rows: RowShards, halo: int, scale: int = 1):
        super().__init__()
        self.inner, self.rows, self.halo, self.scale = inner, rows, halo, scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rows.apply(self.inner, x, self.halo, self.scale)


class HaloSite(nn.Module):
    """An up-head site (`site(x, srb=, a=, use_tanh=)`) on a row shard: x
    extended by `halo` source rows, srb and a weight map padded with zero
    rows there (the rows they feed are cropped), the image cropped."""

    def __init__(self, site: nn.Module, rows: RowShards, halo: int):
        super().__init__()
        self.site, self.rows, self.halo = site, rows, halo

    def forward(self, x: torch.Tensor, srb: Optional[torch.Tensor] = None,
                a: Optional[torch.Tensor] = None, use_tanh: bool = False) -> torch.Tensor:
        ext, top, bottom = self.rows.extend(x, self.halo)
        pad = (0, 0, 2 * top, 2 * bottom)
        if srb is not None:
            srb = F.pad(srb, pad)
        if a is not None and a.dim() == 2:  # a weight map; a scalar blends every row
            a = F.pad(a, pad)
        return _crop(self.site(ext, srb=srb, a=a, use_tanh=use_tanh), 2 * top, 2 * bottom)


def _halo_of(m: nn.Module) -> Optional[Tuple[int, int]]:
    """(halo, output rows per input row) of an op that reads rows above and
    below, or None for a module whose children are walked instead. A module
    of the port declares its own as `row_halo`; torch's convolution is read
    from its kernel. A module that declares none and holds a 4-D weight or
    buffer (a spatial kernel, which functional code may apply across rows)
    raises, as pooling does."""
    rule = getattr(m, "row_halo", None)
    if rule is not None:
        return rule
    if isinstance(m, nn.Conv2d):
        k = m.kernel_size[0]
        if k == 1:
            return None
        if m.stride != (1, 1) or m.dilation != (1, 1) or m.padding != (k // 2, k // 2):
            raise NotImplementedError(f"sr_spatial: no halo rule for {m}")
        return k // 2, 1
    if isinstance(m, (nn.MaxPool2d, nn.AvgPool2d, nn.AdaptiveAvgPool2d)):
        raise NotImplementedError(f"sr_spatial: no halo rule for {m}")
    if any(t is not None and t.dim() == 4
           for t in itertools.chain(m._parameters.values(), m._buffers.values())):
        raise NotImplementedError(f"sr_spatial: {type(m).__name__} holds a spatial kernel "
                                  "and declares no row_halo")
    return None


def _shard_children(module: nn.Module, rows: RowShards, memo: dict) -> None:
    for name, child in list(module._modules.items()):
        if child is None:
            continue
        if id(child) not in memo:  # a module bound under several names is wrapped once
            rule = _halo_of(child)
            if rule is None:
                memo[id(child)] = child
                _shard_children(child, rows, memo)
            else:
                memo[id(child)] = Halo(child, rows, *rule)
        module._modules[name] = memo[id(child)]


def shard_generator(generator: nn.Module, rows: RowShards) -> nn.Module:
    """A copy of a served generator (float or int8) whose ops run on this
    rank's rows with their halos; its weight maps sliced to those rows, and
    its HF input (`low_input`) made over `low_input_halo` rows more each way."""
    gen = copy.deepcopy(generator)
    _shard_children(gen, rows, {})
    for name, p in list(gen.named_parameters(recurse=False)):
        if name[0] == "a" and name[1:].isdigit():  # EVAL.WEIGHTMAP's a1, a2, ...
            setattr(gen, name, nn.Parameter(rows.local(p.detach(), 0).clone(),
                                            requires_grad=False))
    if hasattr(gen, "low_input_halo"):
        own, halo = gen.low_input, gen.low_input_halo
        gen.low_input = lambda lr: rows.apply(own, lr, halo)
    return gen


def site_halo(head_k: int) -> int:
    """Source rows an up-head site needs: the up-conv's 1 and the head's
    k // 2 upsampled rows, halved, rounded up."""
    return -(-(1 + head_k // 2) // 2)


def shard_serving(serving: nn.Module, rows: RowShards) -> nn.Module:
    """A `ServingForward` of row-sharded copies of `serving`'s generators and
    up-head sites (the text encoder shared); `rows` as its attribute."""
    netg, netgh = serving.netg, serving.netgh
    sites: List[Optional[nn.Module]] = []
    for site, head in ((serving.netg_up_head, lambda: getattr(netg, f"img_net{netg.n_stages}")
                        .img[0]), (serving.netgh_up_head, lambda: netgh.conv_output[0])):
        sites.append(None if site is None else
                     HaloSite(site, rows, site_halo(head().kernel_size[0])))
    out = type(serving)(serving.text_encoder, shard_generator(netg, rows),
                        shard_generator(netgh, rows), *sites, serving.compute_dtype,
                        serving.uint8)
    out.rows = rows
    return out
