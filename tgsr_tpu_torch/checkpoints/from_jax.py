"""Weights for the port (counterpart of tgsr_tpu/checkpoints/export_torch.py).

`state_dicts_from_jax` turns the JAX package's {'params', 'batch_stats'}
trees (nested dicts of numpy arrays) into state dicts under the reference's
key names and OIHW layouts, which load into the port's modules with
`strict=True`; `init_seeded` makes such state dicts from a torch.Generator
for runs without JAX. Layout rules, as the JAX exporter's:
  conv kernel HWIO -> OIHW; Dense [in, out] -> [out, in];
  the word projection Dense -> conv_context [idf, cdf, 1, 1];
  BN scale/bias + mean/var -> weight/bias/running_mean/running_var
    (+ num_batches_tracked = 0, which eval never reads);
  RNN w_ih [in, G*H] -> weight_ih_l0 [G*H, in] (G = 4 gates for the LSTM,
    3 for the GRU; the gate order kept by the transpose); bwd -> `_reverse`
    keys.
The blend `a` is not a reference state-dict entry; it is returned apart
(None for a weight-map netGH, whose maps a1..a4 are state-dict entries, as
in the reference). Conv weights are placed through one table of JAX conv
paths (the keys of `tgsr_tpu`'s calibrated int8 scales,
`h_net1/residual_0/conv1`) to port module paths
(`h_net1.residual.0.block.0`): `netg_conv_sites`, `stage1_conv_sites`,
`netgh_conv_sites`, `conv_sites`. The stage-1 generator (EVAL.STAGE1, JAX's
GSRNetLowStage1) has no BN, so its tree has params only, as JAX's
convert_netg_low_stage1 makes it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tgsr_tpu_torch.config import Config
from tgsr_tpu_torch.models.generator import GSRNetLowStage1
from tgsr_tpu_torch.models.models16 import UNUSED_BLOCKS, make_generators

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _put_bn(out: StateDict, prefix: str, params: Mapping, stats: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _put_resblock_bn(out: StateDict, prefix: str, params: Mapping,
                     stats: Mapping) -> None:
    """The BNs of Sequential(conv, BN, GLU, conv, BN), at indices 1 and 4."""
    _put_bn(out, f"{prefix}.1", params["bn1"], stats["bn1"])
    _put_bn(out, f"{prefix}.4", params["bn2"], stats["bn2"])


def _resblock_sites(key: str, path: str) -> Dict[str, str]:
    """conv1 / conv2 of a block run as Sequential(conv, BN, GLU, conv, BN):
    Sequential indices 0 and 3."""
    return {f"{key}/conv1": f"{path}.0", f"{key}/conv2": f"{path}.3"}


def netg_conv_sites(n_stages: int, r_num: int, tied: bool = False) -> Dict[str, str]:
    """GSRNetLow: JAX conv path (the key of a calibrated-scales group and of
    `conv_kernel_sites`) -> the port's module path of that conv. `tied`: the
    x16 GSRNetLow16, whose tree names its one shared stage h_net2 and its one
    shared head img_net1 (the port module's other names alias them)."""
    sites = {"h_net1/im2f_conv": "h_net1.im2f.0"}
    for k in range(1, (2 if tied else n_stages) + 1):
        for j in range(r_num):
            sites.update(_resblock_sites(f"h_net{k}/residual_{j}",
                                         f"h_net{k}.residual.{j}.block"))
        sites[f"h_net{k}/upsample/conv"] = f"h_net{k}.upsample.1"
    for k in range(1, (1 if tied else n_stages) + 1):
        sites[f"img_net{k}/conv"] = f"img_net{k}.img.0"
    return sites


def stage1_conv_sites(r_num: int) -> Dict[str, str]:
    """GSRNetLowStage1: JAX conv path -> the port's module path. Its blocks
    have no BN: a ResBlock is Sequential(conv, GLU, conv), an UpBlockNoBN
    Sequential(Upsample, conv, GLU); `up1` is Sequential(conv, LeakyReLU,
    UpBlockNoBN), called twice under one key each."""
    sites = {"h_net1/im2f_conv": "h_net1.im2f.0"}
    for j in range(r_num):
        sites[f"h_net1/residual_{j}/conv1"] = f"h_net1.residual.{j}.block.0"
        sites[f"h_net1/residual_{j}/conv2"] = f"h_net1.residual.{j}.block.2"
    sites.update({"h_net1/upsample/conv": "h_net1.upsample.1", "up1_conv": "up1.0",
                  "up1_up/conv": "up1.2.1"})
    for name in ("h_net2", "h_net3"):
        sites[f"{name}/conv1"] = f"{name}.block.0"
        sites[f"{name}/conv2"] = f"{name}.block.2"
    for k in (1, 2, 3):
        sites[f"img_net{k}/conv"] = f"img_net{k}.img.0"
    return sites


def netgh_conv_sites(n_res: int, unused: Tuple[str, ...] = ()) -> Dict[str, str]:
    """NetGHighWeight (any input, with or without a weight map), or the x16
    NetGHighWeight16 with the declared blocks `unused` that its weights carry
    (residual816, upscale16x): JAX conv path -> the port's module path."""
    sites = {"convin/conv": "convin.0"}
    for j in range(n_res):
        sites.update(_resblock_sites(f"residual_{j}", f"residual.{j}.block"))
    for scale in ("2x", "4x", "8x"):
        sites[f"upscale{scale}/conv"] = f"upscale{scale}.1"
    for name in ("residual24", "residual48"):
        sites.update(_resblock_sites(name, name))
    sites["conv_output/conv"] = "conv_output.0"
    if "residual816" in unused:
        sites.update(_resblock_sites("residual816", "residual816"))
    if "upscale16x" in unused:
        sites["upscale16x/conv"] = "upscale16x.1"
    return sites


def conv_sites(netg: nn.Module, netgh: nn.Module) -> Dict[str, Dict[str, str]]:
    """{"netg": {...}, "netgh": {...}} for the port's two generators: the
    one table from JAX conv paths to port modules that the state dicts,
    calibration, `check_scales` and `weights_fingerprint` all use. A module
    bound under several names (the x16 family's tied stage and head) is
    named once, under the JAX tree's name."""
    r_num = len(netg.h_net1.residual)
    return {"netg": (stage1_conv_sites(r_num) if isinstance(netg, GSRNetLowStage1)
                     else netg_conv_sites(netg.n_stages, r_num, netg.tied)),
            "netgh": netgh_conv_sites(len(netgh.residual),
                                      tuple(n for n in UNUSED_BLOCKS if hasattr(netgh, n)))}


def _at(tree: Mapping, key: str) -> Mapping:
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _put_convs(out: StateDict, params: Mapping, sites: Mapping[str, str]) -> None:
    for key, path in sites.items():
        out[f"{path}.weight"] = _conv(_at(params, key)["kernel"])


def _count(params: Mapping, fmt: str, start: int = 0) -> int:
    n = start
    while fmt.format(n) in params:
        n += 1
    return n - start


def netg_state_dict(variables: Mapping) -> StateDict:
    """GSRNetLow tree -> G_SR_NET_low state dict; a GSRNetLow16 tree (one
    shared stage h_net2 and one shared head img_net1, no img_net2) -> the
    x16 G_SR_NET_low state dict, whose h_net3 / h_net4 and img_net2..4 key
    sets repeat the shared tensors (models16.py:13-14); a GSRNetLowStage1
    tree (params only) -> the G_SR_NET_low_stage1 state dict without the
    reference's dead `up2` (`stage1_state_dict`)."""
    if "up1_conv" in variables["params"]:
        return stage1_state_dict(variables)
    params, stats = variables["params"], variables["batch_stats"]
    n_stages = _count(params, "h_net{}", start=1)
    tied = n_stages == 2 and "img_net2" not in params
    out: StateDict = {
        "ca_net.fc.weight": _t(np.asarray(params["ca_net"]["fc"]["kernel"]).T),
        "ca_net.fc.bias": _t(params["ca_net"]["fc"]["bias"]),
    }
    _put_convs(out, params, netg_conv_sites(
        n_stages, _count(params["h_net1"], "residual_{}"), tied))
    _put_bn(out, "h_net1.im2f.1", params["h_net1"]["im2f_bn"],
            stats["h_net1"]["im2f_bn"])
    for k in range(1, n_stages + 1):
        hp, hs = params[f"h_net{k}"], stats[f"h_net{k}"]
        w = np.asarray(hp["att"]["conv_context"]["kernel"]).T  # [idf, cdf]
        out[f"h_net{k}.att.conv_context.weight"] = _t(w[:, :, None, None])
        for j in range(_count(hp, "residual_{}")):
            _put_resblock_bn(out, f"h_net{k}.residual.{j}.block",
                             hp[f"residual_{j}"], hs[f"residual_{j}"])
        _put_bn(out, f"h_net{k}.upsample.2", hp["upsample"]["bn"], hs["upsample"]["bn"])
    if tied:
        for src, aliases in (("h_net2.", ("h_net3.", "h_net4.")),
                             ("img_net1.", ("img_net2.", "img_net3.", "img_net4."))):
            shared = {k[len(src):]: v for k, v in out.items() if k.startswith(src)}
            for alias in aliases:
                out.update({alias + k: v for k, v in shared.items()})
    return out


def stage1_state_dict(variables: Mapping) -> StateDict:
    """A GSRNetLowStage1 tree -> the G_SR_NET_low_stage1 state dict (no BN;
    the reference's unused `up2` left out, as JAX's converter drops it)."""
    params = variables["params"]
    out: StateDict = {
        "ca_net.fc.weight": _t(np.asarray(params["ca_net"]["fc"]["kernel"]).T),
        "ca_net.fc.bias": _t(params["ca_net"]["fc"]["bias"]),
        "h_net1.att.conv_context.weight": _t(np.asarray(
            params["h_net1"]["att"]["conv_context"]["kernel"]).T[:, :, None, None]),
    }
    _put_convs(out, params, stage1_conv_sites(_count(params["h_net1"], "residual_{}")))
    return out


WEIGHT_MAPS = ("a1", "a2", "a3", "a4")  # NetG_highweight's maps (EVAL.WEIGHTMAP)


def netgh_state_dict(variables: Mapping) -> Tuple[StateDict, Optional[float]]:
    """NetGHighWeight tree -> (NetG_highweight state dict, blend weight a):
    with a weight map the tree's a1..a3 (x16 a1..a4) are state-dict entries
    and a is None; without one a is params['a']. A NetGHighWeight16 tree
    gives the x16 NetG_highweight's, with residual816 / upscale16x where the
    tree carries them."""
    params = variables["params"]
    out = netgh_conv_bn_state_dict(variables)
    out.update({n: _t(params[n]) for n in WEIGHT_MAPS if n in params})
    a = float(np.asarray(params["a"]).reshape(-1)[0]) if "a" in params else None
    return out, a


def netgh_conv_bn_state_dict(variables: Mapping) -> StateDict:
    """The convs and BNs of a NetGHighWeight(16) tree under the reference's
    keys: `netgh_state_dict` without the blend weight, for a tree with or
    without a weight map."""
    params, stats = variables["params"], variables["batch_stats"]
    n_res = _count(params, "residual_{}")
    unused = tuple(n for n in UNUSED_BLOCKS if n in params)
    out: StateDict = {}
    _put_convs(out, params, netgh_conv_sites(n_res, unused))
    _put_bn(out, "convin.1", params["convin"]["bn"], stats["convin"]["bn"])
    for j in range(n_res):
        _put_resblock_bn(out, f"residual.{j}.block", params[f"residual_{j}"],
                         stats[f"residual_{j}"])
    for name in ("upscale2x", "upscale4x", "upscale8x", "upscale16x"):
        if name in params:
            _put_bn(out, f"{name}.2", params[name]["bn"], stats[name]["bn"])
    for name in ("residual24", "residual48", "residual816"):
        if name in params:
            _put_resblock_bn(out, name, params[name], stats[name])
    return out


def text_state_dict(variables: Mapping) -> StateDict:
    """TextEncoder tree (LSTM or GRU, the gate count read from the shapes) ->
    RNN_ENCODER state dict; a direction the tree lacks (a unidirectional
    tree) is left out, as JAX's exporter does."""
    params = variables["params"]
    out: StateDict = {"encoder.weight": _t(params["embedding"])}
    for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
        if f"w_ih_{d}" not in params:
            continue
        out[f"rnn.weight_ih_l0{suffix}"] = _t(np.asarray(params[f"w_ih_{d}"]).T)
        out[f"rnn.weight_hh_l0{suffix}"] = _t(np.asarray(params[f"w_hh_{d}"]).T)
        out[f"rnn.bias_ih_l0{suffix}"] = _t(params[f"b_ih_{d}"])
        out[f"rnn.bias_hh_l0{suffix}"] = _t(params[f"b_hh_{d}"])
    return out


def state_dicts_from_jax(text_vars: Mapping, netg_vars: Mapping,
                         netgh_vars: Mapping
                         ) -> Tuple[StateDict, StateDict, StateDict, Optional[float]]:
    """JAX variable trees -> (text_sd, netg_sd, netgh_sd, a)."""
    netgh_sd, a = netgh_state_dict(netgh_vars)
    return text_state_dict(text_vars), netg_state_dict(netg_vars), netgh_sd, a


# -- the port's weights as flax trees, and the discriminators' ------------------

def _np(x) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy().copy()


def _set(tree: Dict[str, Any], key: str, value) -> None:
    *parts, leaf = key.split("/")
    for part in parts:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _get_bn(variables: Dict[str, Any], key: str, sd: Mapping[str, torch.Tensor],
            prefix: str) -> None:
    _set(variables["params"], f"{key}/scale", _np(sd[f"{prefix}.weight"]))
    _set(variables["params"], f"{key}/bias", _np(sd[f"{prefix}.bias"]))
    _set(variables["batch_stats"], f"{key}/mean", _np(sd[f"{prefix}.running_mean"]))
    _set(variables["batch_stats"], f"{key}/var", _np(sd[f"{prefix}.running_var"]))


def _get_convs(params: Dict[str, Any], sd: Mapping[str, torch.Tensor],
               sites: Mapping[str, str]) -> None:
    for key, path in sites.items():
        _set(params, f"{key}/kernel", _np(sd[f"{path}.weight"]).transpose(2, 3, 1, 0))


# the x16 G_SR_NET_low's aliases (models16.py:13-14): alias prefix -> the shared module's
X16_NETG_ALIASES = {"h_net3.": "h_net2.", "h_net4.": "h_net2.", "img_net2.": "img_net1.",
                    "img_net3.": "img_net1.", "img_net4.": "img_net1."}


def netg_variables(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `netg_state_dict`: a G_SR_NET_low state dict -> the JAX
    GSRNetLow's {'params', 'batch_stats'} tree of numpy float32 arrays (HWIO
    kernels, Dense [in, out]); the x16 family's (four stages, h_net3 / h_net4
    and img_net2..4 the aliases of h_net2 and img_net1) -> the GSRNetLow16
    tree, the shared stage and head written once (ValueError where an alias
    holds other values); a G_SR_NET_low_stage1 state dict -> the
    GSRNetLowStage1 tree ({'params'} only: no BN; `up2`, which never runs,
    dropped as JAX's convert_netg_low_stage1 drops it). num_batches_tracked,
    which the JAX tree has no place for, is dropped."""
    if "up1.0.weight" in sd:
        return stage1_variables(sd)
    n_stages = _count({k.split(".")[0]: 0 for k in sd}, "h_net{}", start=1)
    r_num = _count({k.split(".")[2]: 0 for k in sd if k.startswith("h_net1.residual.")}, "{}")
    tied = n_stages == 4  # only the x16 family has four stages
    if tied:
        for k, v in sd.items():
            src = next((s + k[len(a):] for a, s in X16_NETG_ALIASES.items() if k.startswith(a)),
                       None)
            if src is not None and not (v.shape == sd[src].shape and torch.allclose(
                    v, sd[src], rtol=0, atol=0, equal_nan=True)):
                raise ValueError(f"{k} differs from {src}: not the x16 family's tied netG")
        n_stages = 2
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    params = out["params"]
    _set(params, "ca_net/fc/kernel", _np(sd["ca_net.fc.weight"]).T.copy())
    _set(params, "ca_net/fc/bias", _np(sd["ca_net.fc.bias"]))
    _get_convs(params, sd, netg_conv_sites(n_stages, r_num, tied))
    _get_bn(out, "h_net1/im2f_bn", sd, "h_net1.im2f.1")
    for k in range(1, n_stages + 1):
        w = _np(sd[f"h_net{k}.att.conv_context.weight"])[:, :, 0, 0]
        _set(params, f"h_net{k}/att/conv_context/kernel", w.T.copy())
        for j in range(r_num):
            for bn, idx in (("bn1", 1), ("bn2", 4)):
                _get_bn(out, f"h_net{k}/residual_{j}/{bn}", sd,
                        f"h_net{k}.residual.{j}.block.{idx}")
        _get_bn(out, f"h_net{k}/upsample/bn", sd, f"h_net{k}.upsample.2")
    return out


def stage1_variables(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `stage1_state_dict` (= JAX's convert_netg_low_stage1):
    a G_SR_NET_low_stage1 state dict -> the GSRNetLowStage1 tree."""
    r_num = _count({k.split(".")[2]: 0 for k in sd if k.startswith("h_net1.residual.")}, "{}")
    params: Dict[str, Any] = {}
    _set(params, "ca_net/fc/kernel", _np(sd["ca_net.fc.weight"]).T.copy())
    _set(params, "ca_net/fc/bias", _np(sd["ca_net.fc.bias"]))
    _set(params, "h_net1/att/conv_context/kernel",
         _np(sd["h_net1.att.conv_context.weight"])[:, :, 0, 0].T.copy())
    _get_convs(params, sd, stage1_conv_sites(r_num))
    return {"params": params}


def netgh_variables(sd: Mapping[str, torch.Tensor], a: Optional[float]) -> Dict[str, Any]:
    """The inverse of `netgh_state_dict` for NetGHighWeight and the x16
    NetGHighWeight16, whose JAX tree has the same keys (its declared
    residual816 / upscale16x never run, and a JAX tree has none): (state
    dict, blend weight a) -> the JAX tree, with params['a'] of shape (1,),
    or, for a weight-map state dict (a None), the maps a1..a4 it carries and
    no 'a'."""
    n_res = _count({k.split(".")[1]: 0 for k in sd if k.startswith("residual.")}, "{}")
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    _get_convs(out["params"], sd, netgh_conv_sites(n_res))
    _get_bn(out, "convin/bn", sd, "convin.1")
    for j in range(n_res):
        for bn, idx in (("bn1", 1), ("bn2", 4)):
            _get_bn(out, f"residual_{j}/{bn}", sd, f"residual.{j}.block.{idx}")
    for name in ("upscale2x", "upscale4x", "upscale8x"):
        _get_bn(out, f"{name}/bn", sd, f"{name}.2")
    for name in ("residual24", "residual48"):
        for bn, idx in (("bn1", 1), ("bn2", 4)):
            _get_bn(out, f"{name}/{bn}", sd, f"{name}.{idx}")
    maps = [n for n in WEIGHT_MAPS if n in sd]
    if maps:
        out["params"].update({n: _np(sd[n]) for n in maps})
    else:
        out["params"]["a"] = np.full((1,), a, np.float32)
    return out


def _dnet_module(key: str) -> str:
    """A JAX DNet module name -> the port's: downs_1 -> downs.1."""
    head, _, idx = key.rpartition("_")
    return f"{head}.{idx}" if head in ("downs", "extra") and idx.isdigit() else key


def dnet_state_dict(variables: Mapping, img_size: int) -> StateDict:
    """A JAX DNet tree -> the port's `DNet` state dict (conv kernels HWIO ->
    OIHW; BN scale / bias / mean / var -> weight / bias / running stats).
    Raises ValueError when the tree is not a DNet of `img_size`."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: StateDict = {}
    for key, mod in params.items():
        name = _dnet_module(key)
        if "kernel" in mod:  # cond_out / uncond_out: a conv with a bias
            out[f"{name}.weight"] = _conv(mod["kernel"])
            out[f"{name}.bias"] = _t(mod["bias"])
            continue
        out[f"{name}.conv.weight"] = _conv(mod["conv"]["kernel"])
        if "bn" in mod:
            _put_bn(out, f"{name}.bn", mod["bn"], stats[key]["bn"])
    downs = _count(params, "downs_{}") + _count(params, "extra_{}") // 2
    if 4 * 2 ** downs != img_size:
        raise ValueError(f"a DNet tree of {4 * 2 ** downs} px, not {img_size}")
    return out


def dnet_variables(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `dnet_state_dict`."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for k, v in sd.items():
        mod, _, leaf = k.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        parts = mod.split(".")
        if parts[0] in ("downs", "extra"):
            parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
        key = "/".join(parts)
        if leaf == "weight" and v.dim() == 4:
            _set(out["params"], f"{key}/kernel", _np(v).transpose(2, 3, 1, 0))
        elif parts[-1] == "bn":
            coll, name = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                          "running_mean": ("batch_stats", "mean"),
                          "running_var": ("batch_stats", "var")}[leaf]
            _set(out[coll], f"{key}/{name}", _np(v))
        else:
            _set(out["params"], f"{key}/{leaf}", _np(v))
    return out


def init_module(module: nn.Module, gen: torch.Generator) -> None:
    """The JAX init's scales from `gen`, in place: conv and Dense weights
    N(0, 1 / fan_in) (flax's lecun_normal variance), biases 0, BN scale 1,
    bias 0, running mean 0, var 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def _seed_module(module: nn.Module, gen: torch.Generator) -> StateDict:
    """Fill a module's weights from `gen` and return its state dict. Conv and
    Linear weights are N(0, 1/fan_in); BN running means and variances are
    drawn away from 0 and 1, and BN scales and biases away from 1 and 0, so
    that eval BN (and its fold in the up-head kernel) does real work."""

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(normal(m.weight.shape, 1.0 / math.sqrt(fan_in)))
                if m.bias is not None:
                    m.bias.copy_(normal(m.bias.shape, 0.1))
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(normal(n, 0.1, 1.0))
                m.bias.copy_(normal(n, 0.1))
                m.running_mean.copy_(normal(n, 0.2))
                m.running_var.copy_(uniform(n, 0.5, 2.0))
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(uniform(m.weight.shape, -0.1, 0.1))
            elif isinstance(m, (nn.LSTM, nn.GRU)):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.copy_(uniform(p.shape, -bound, bound))
        for name in WEIGHT_MAPS:
            if isinstance(getattr(module, name, None), nn.Parameter):
                getattr(module, name).copy_(uniform(getattr(module, name).shape, 0.5, 1.5))
    return {k: v.clone() for k, v in module.state_dict().items()}


def init_seeded(cfg: Config, vocab_size: int, generator: torch.Generator
                ) -> Tuple[StateDict, StateDict, StateDict, Optional[float]]:
    """Random weights for the pipeline of cfg's family, made from `generator`
    on the CPU: (text_sd, netg_sd, netgh_sd, a), in the form
    `state_dicts_from_jax` returns (x16: without the netGH blocks that never
    run, as a JAX init). A tied module is drawn once. `a` is 0.5, the JAX
    init; under EVAL.WEIGHTMAP it is None and the maps a1.. are drawn
    non-uniform, 1 + U(-0.5, 0.5) (a map of ones would hide an indexing
    fault)."""
    text = seeded_text_state_dict(cfg, vocab_size, generator)
    netg, netgh = make_generators(cfg)
    return (text, _seed_module(netg, generator), _seed_module(netgh, generator),
            None if cfg.EVAL.WEIGHTMAP else 0.5)


def seeded_text_state_dict(cfg: Config, vocab_size: int, generator: torch.Generator
                           ) -> StateDict:
    """Random weights of cfg's TextEncoder (cfg.RNN_TYPE) from `generator`
    (the first of `init_seeded`'s draws): the embedding U(-0.1, 0.1), the
    LSTM's or GRU's tensors U(-1 / sqrt(H), 1 / sqrt(H))."""
    from tgsr_tpu_torch.models.text_encoder import TextEncoder

    return _seed_module(TextEncoder(vocab_size, 300, cfg.TEXT.EMBEDDING_DIM,
                                    rnn_type=cfg.RNN_TYPE), generator)


def text_variables(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `text_state_dict`: a RNN_ENCODER state dict -> the JAX
    TextEncoder's {'params'} tree (weights [in, 4H] for the LSTM, [in, 3H]
    for the GRU)."""
    params: Dict[str, Any] = {"embedding": _np(sd["encoder.weight"])}
    for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
        params[f"w_ih_{d}"] = _np(sd[f"rnn.weight_ih_l0{suffix}"]).T.copy()
        params[f"w_hh_{d}"] = _np(sd[f"rnn.weight_hh_l0{suffix}"]).T.copy()
        params[f"b_ih_{d}"] = _np(sd[f"rnn.bias_ih_l0{suffix}"])
        params[f"b_hh_{d}"] = _np(sd[f"rnn.bias_hh_l0{suffix}"])
    return {"params": params}


# -- the DAMSM image encoders (models/image_encoder.py) ------------------------
# Inception: each BasicConv2d is {conv: {kernel}, bn: {scale, bias}} under
# params['inception'] at its torchvision path, its stats {bn: {mean, var}}
# under batch_stats['inception']; the state dict keys are the torchvision
# paths at the top level (`Mixed_5b.branch1x1.conv.weight`), as the
# reference's CNN_ENCODER and tgsr_tpu's export_cnn_encoder write them.
# SimpleCNN: conv{i}, bn{i}, conv_17 at the top level of both.

def is_inception_state_dict(sd: Mapping[str, Any]) -> bool:
    """The family test on a state dict; on a tree JAX's is `"inception" in
    params` (tgsr_tpu/cli/train_gan.py)."""
    return "Conv2d_1a_3x3.conv.weight" in sd


def cnn_encoder_state_dict(variables: Mapping) -> StateDict:
    """A JAX CNNEncoder or SimpleCNNEncoder tree -> the port's state dict of
    that family (conv HWIO -> OIHW, Dense [in, out] -> [out, in],
    emb_features -> a [nef, C, 1, 1] conv). A tree without the heads (a
    converted zoo backbone) gives the backbone's keys only."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: StateDict = {}
    if "inception" in params:
        def walk(p: Mapping, s: Mapping, path: str) -> None:
            if "kernel" in p.get("conv", {}):
                out[f"{path}.conv.weight"] = _conv(p["conv"]["kernel"])
                _put_bn(out, f"{path}.bn", p["bn"], s["bn"])
                return
            for name in p:
                walk(p[name], s.get(name, {}), f"{path}.{name}" if path else name)

        walk(params["inception"], stats.get("inception", {}), "")
    else:
        for key in [k for k in params if k.startswith("conv")]:
            out[f"{key}.weight"] = _conv(params[key]["kernel"])
        for key in [k for k in params if k.startswith("bn")]:
            _put_bn(out, key, params[key], stats[key])
    if "emb_features" in params:
        out["emb_features.weight"] = _t(np.asarray(params["emb_features"]["kernel"]).T)[:, :, None, None]
        out["emb_cnn_code.weight"] = _t(np.asarray(params["emb_cnn_code"]["kernel"]).T)
        out["emb_cnn_code.bias"] = _t(params["emb_cnn_code"]["bias"])
    return out


def cnn_encoder_variables(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `cnn_encoder_state_dict`: the JAX tree of either family
    (num_batches_tracked dropped)."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    root = "inception/" if is_inception_state_dict(sd) else ""
    names = {"weight": ("params", "scale"), "bias": ("params", "bias"),
             "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    for k, v in sd.items():
        mod, _, leaf = k.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        if mod == "emb_features":
            _set(out["params"], "emb_features/kernel", _np(v)[:, :, 0, 0].T.copy())
        elif mod == "emb_cnn_code":
            _set(out["params"], f"emb_cnn_code/{'kernel' if leaf == 'weight' else 'bias'}",
                 _np(v).T.copy() if leaf == "weight" else _np(v))
        elif v.dim() == 4:
            key = mod.replace(".", "/")
            _set(out["params"], f"{root}{key}/kernel", _np(v).transpose(2, 3, 1, 0).copy())
        else:
            coll, name = names[leaf]
            _set(out[coll], f"{root}{mod.replace('.', '/')}/{name}", _np(v))
    return out


def seeded_cnn_encoder_state_dict(simple: bool, nef: int, generator: torch.Generator
                                  ) -> StateDict:
    """Random image-encoder weights of one family from `generator`, BN
    statistics and affine moved away from (0, 1) as `init_seeded`'s."""
    from tgsr_tpu_torch.models.image_encoder import make_image_encoder

    return _seed_module(make_image_encoder(simple, nef), generator)


# -- the library modules (ops/blocks, models/variants, ESRGANDNet, VGG16) ------
# These carry the JAX package's flax names as module names, or list them in a
# `flax_names` attribute ({port child path: flax path}, the reference's
# Sequential indices of a block -> JAX's `conv` / `bn`), so one walk gives the
# table from port modules to JAX tree paths. JAX has no converter for them
# (no reference weights exist), except VGG16's torchvision one.

_LEAVES = (nn.Conv2d, nn.Linear, nn.modules.batchnorm._BatchNorm)


def flax_leaves(module: nn.Module) -> Dict[str, Tuple[str, nn.Module]]:
    """{port module path: (JAX tree path, module)} for every conv, Linear and
    BatchNorm under `module`: a child's flax name is its `flax_names` entry
    in its parent, else its own name."""
    out: Dict[str, Tuple[str, nn.Module]] = {}

    def walk(m: nn.Module, port: str, flax: str) -> None:
        if isinstance(m, _LEAVES):
            out[port] = (flax, m)
            return
        names = dict(getattr(m, "flax_names", None) or {})
        heads = {k.split(".")[0] for k in names}
        names.update({n: n for n, _ in m.named_children() if n not in heads})
        for rel, fl in names.items():
            walk(m.get_submodule(rel), f"{port}.{rel}" if port else rel,
                 f"{flax}/{fl}" if flax else fl)

    walk(module, "", "")
    return out


def library_state_dict(module: nn.Module, variables: Mapping) -> StateDict:
    """A JAX tree of the library module that `module` ports -> `module`'s
    state dict (strict): conv kernels HWIO -> OIHW, Dense [in, out] ->
    [out, in] (a word projection `conv_context` -> a 1x1 conv), BN scale /
    bias / mean / var -> weight / bias / running stats."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: StateDict = {}
    for port, (flax, m) in flax_leaves(module).items():
        p = _at(params, flax)
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            _put_bn(out, port, p, _at(stats, flax))
            continue
        if isinstance(m, nn.Linear):
            out[f"{port}.weight"] = _t(np.asarray(p["kernel"]).T)
        elif flax.endswith("conv_context"):
            out[f"{port}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
        else:
            out[f"{port}.weight"] = _conv(p["kernel"])
        if m.bias is not None:
            out[f"{port}.bias"] = _t(p["bias"])
    return out


def library_variables(module: nn.Module) -> Dict[str, Any]:
    """The inverse of `library_state_dict`: `module`'s weights -> the JAX
    tree {'params'[, 'batch_stats']}."""
    sd = module.state_dict()
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for port, (flax, m) in flax_leaves(module).items():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            _get_bn(out, flax, sd, port)
            continue
        w = _np(sd[f"{port}.weight"])
        if isinstance(m, nn.Linear):
            w = w.T.copy()
        elif flax.endswith("conv_context"):
            w = w[:, :, 0, 0].T.copy()
        else:
            w = w.transpose(2, 3, 1, 0).copy()
        _set(out["params"], f"{flax}/kernel", w)
        if m.bias is not None:
            _set(out["params"], f"{flax}/bias", _np(sd[f"{port}.bias"]))
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def vgg16_state_dict(variables: Mapping) -> StateDict:
    """A JAX VGG16Features tree (conv0..conv12) -> the port's VGG16Features
    state dict under torchvision's `features.N` keys, the inverse of JAX's
    `convert_vgg16` (tgsr_tpu/models/vgg.py:49)."""
    from tgsr_tpu_torch.models.vgg import CONV_INDICES

    params = variables["params"]
    out: StateDict = {}
    for li, i in enumerate(CONV_INDICES):
        out[f"features.{i}.weight"] = _conv(params[f"conv{li}"]["kernel"])
        out[f"features.{i}.bias"] = _t(params[f"conv{li}"]["bias"])
    return out


def vgg16_variables(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A torchvision `vgg16` state dict (its `features.N`; `classifier.`
    ignored) or the port's VGG16Features' -> the JAX tree, as JAX's
    `convert_vgg16` makes it."""
    from tgsr_tpu_torch.models.vgg import CONV_INDICES

    return {"params": {f"conv{li}": {"kernel": _np(sd[f"features.{i}.weight"]).transpose(
        2, 3, 1, 0).copy(), "bias": _np(sd[f"features.{i}.bias"])}
        for li, i in enumerate(CONV_INDICES)}}
