"""The reference's checkpoint files (counterpart of
tgsr_tpu/checkpoints/convert_torch.py `paired_path`, `load_generator_pair`
for the families `config.check_served` names, and `convert_cnn_encoder`).

A reference `.pth` already carries the port's key names and OIHW layouts, so
it loads as it is, with `torch.load(weights_only=True)`, and the modules
take it with `load_state_dict(strict=True)`. A `.msgpack` file (a flax tree,
`cli.train_gan`'s netG_it* / netGH_it* snapshots) goes through `msgpack_io`
and `from_jax`.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import torch

from tgsr_tpu_torch.checkpoints.from_jax import (WEIGHT_MAPS, StateDict,
                                                 cnn_encoder_state_dict, netg_state_dict,
                                                 netgh_state_dict, text_state_dict)
from tgsr_tpu_torch.checkpoints.msgpack_io import load_variables
from tgsr_tpu_torch.config import Config, check_served

DEFAULT_A = 0.5  # the reference builds NetG_highweight with a = 0.5 (model.py:246-248)


def paired_path(path: str, a: str, b: str) -> str:
    """The companion file, named by substituting `a` -> `b` in the basename
    only (netG -> netGH, trainer_objective.py:91-93); a directory whose name
    contains `a` is not rewritten."""
    d, base = os.path.split(path)
    return os.path.join(d, base.replace(a, b))


def _load_pth(path: str) -> StateDict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_generator_pair(cfg: Config, netg_path: str, netgh_path: Optional[str] = None
                        ) -> Tuple[StateDict, StateDict, Optional[float]]:
    """(netg_sd, netgh_sd, a). netgh_path defaults to netg_path's pair. A
    `.pth` netGH carries no `a` (it is not a registered parameter of the
    reference), so a is 0.5 unless the file has one; a `.msgpack` pair
    carries its trained `a`. Under EVAL.WEIGHTMAP a is None and the netGH
    state dict keeps the file's maps a1..a4 (without it they are dropped, as
    JAX's convert_netgh_weight(weightmap=False) drops them). An x16 `.pth`
    carries the reference's aliased key sets (h_net2/3/4, img_net1..4), which
    the port's tied modules take as they are, and residual816 / upscale16x,
    which its netGH then declares (`models16.unused_blocks`). Under
    EVAL.STAGE1 (x8) netG is a G_SR_NET_low_stage1 file, read as JAX's
    convert_netg_low_stage1 reads it: its dead `up2` dropped. JAX's own
    `load_generator_pair` converts every x8 `.pth` with convert_netg_low,
    whatever STAGE1 says, and so cannot read one (ROADMAP, Queue C 4)."""
    check_served(cfg)
    wm = cfg.EVAL.WEIGHTMAP
    if netgh_path is None:
        netgh_path = paired_path(netg_path, "netG", "netGH")
    if netg_path.endswith(".msgpack"):
        netgh_sd, a = netgh_state_dict(load_variables(netgh_path))
        return netg_state_dict(load_variables(netg_path)), netgh_sd, a
    netgh_sd = dict(_load_pth(netgh_path))
    a = float(netgh_sd.pop("a").reshape(-1)[0]) if "a" in netgh_sd else DEFAULT_A
    if not wm:
        netgh_sd = {k: v for k, v in netgh_sd.items() if k not in WEIGHT_MAPS}
    netg_sd = _load_pth(netg_path)
    if cfg.EVAL.STAGE1 and cfg.TREE.BRANCH_NUM == 4:
        netg_sd = {k: v for k, v in netg_sd.items() if not k.startswith("up2.")}
    return netg_sd, netgh_sd, None if wm else a


def rnn_type_of(sd: Mapping[str, torch.Tensor]) -> str:
    """'LSTM' or 'GRU': the recurrence of a RNN_ENCODER state dict, read from
    its gate count (weight_hh_l0 is [4H, H] for the LSTM, [3H, H] for the
    GRU)."""
    rows, hidden = sd["rnn.weight_hh_l0"].shape
    gates = {4: "LSTM", 3: "GRU"}.get(rows // hidden if rows % hidden == 0 else 0)
    if gates is None:
        raise ValueError(f"rnn.weight_hh_l0 of shape {tuple(sd['rnn.weight_hh_l0'].shape)} is "
                         "neither an LSTM's [4H, H] nor a GRU's [3H, H]")
    return gates


def load_text_encoder(path: str, rnn_type: str = "LSTM") -> StateDict:
    """A reference text_encoder `.pth`, or a flax TextEncoder tree, of the
    recurrence `rnn_type` (cfg.RNN_TYPE). A file of the other recurrence is
    refused with ValueError naming both (JAX's `convert_text_encoder(sd,
    rnn_type)` converts either and its TextEncoder then fails on the
    shapes)."""
    sd = _load_pth(path) if path.endswith(".pth") else text_state_dict(load_variables(path))
    found = rnn_type_of(sd)
    if found != rnn_type:
        raise ValueError(f"{path} holds a {found} text encoder; the config's RNN_TYPE is "
                         f"{rnn_type!r}")
    return sd


# the parts of torchvision's inception_v3 that CNN_ENCODER does not keep
ZOO_ONLY = ("fc.", "AuxLogits.")


def load_image_encoder(path: str) -> StateDict:
    """A DAMSM image encoder's state dict: a reference `image_encoder<N>.pth`
    (CNN_ENCODER: the Inception backbone under torchvision's names and the
    two heads, as it loads strict into `CNNEncoder`), a bare torchvision
    `inception_v3` zoo `.pth` (the backbone only: its `fc.` and `AuxLogits`
    dropped, the heads left to the caller's init), or a `.msgpack` flax tree
    of either family (`cli.pretrain_damsm`'s snapshots)."""
    if path.endswith(".msgpack"):
        return cnn_encoder_state_dict(load_variables(path))
    return {k: v for k, v in _load_pth(path).items() if not k.startswith(ZOO_ONLY)}
