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
  LSTM w_ih [in, 4H] -> weight_ih_l0 [4H, in]; bwd -> `_reverse` keys.
The blend `a` is not a reference state-dict entry; it is returned apart.
Conv weights are placed through one table of JAX conv paths (the keys of
`tgsr_tpu`'s calibrated int8 scales, `h_net1/residual_0/conv1`) to port
module paths (`h_net1.residual.0.block.0`): `netg_conv_sites`,
`netgh_conv_sites`, `conv_sites`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from tgsr_tpu_torch.config import Config

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


def netg_conv_sites(n_stages: int, r_num: int) -> Dict[str, str]:
    """GSRNetLow: JAX conv path (the key of a calibrated-scales group and of
    `conv_kernel_sites`) -> the port's module path of that conv."""
    sites = {"h_net1/im2f_conv": "h_net1.im2f.0"}
    for k in range(1, n_stages + 1):
        for j in range(r_num):
            sites.update(_resblock_sites(f"h_net{k}/residual_{j}",
                                         f"h_net{k}.residual.{j}.block"))
        sites[f"h_net{k}/upsample/conv"] = f"h_net{k}.upsample.1"
        sites[f"img_net{k}/conv"] = f"img_net{k}.img.0"
    return sites


def netgh_conv_sites(n_res: int) -> Dict[str, str]:
    """NetGHighWeight (low 'lr', no weight map): JAX conv path -> the port's
    module path."""
    sites = {"convin/conv": "convin.0"}
    for j in range(n_res):
        sites.update(_resblock_sites(f"residual_{j}", f"residual.{j}.block"))
    for scale in ("2x", "4x", "8x"):
        sites[f"upscale{scale}/conv"] = f"upscale{scale}.1"
    for name in ("residual24", "residual48"):
        sites.update(_resblock_sites(name, name))
    sites["conv_output/conv"] = "conv_output.0"
    return sites


def conv_sites(netg: nn.Module, netgh: nn.Module) -> Dict[str, Dict[str, str]]:
    """{"netg": {...}, "netgh": {...}} for the port's two generators: the
    one table from JAX conv paths to port modules that the state dicts,
    calibration, `check_scales` and `weights_fingerprint` all use."""
    return {"netg": netg_conv_sites(netg.n_stages, len(netg.h_net1.residual)),
            "netgh": netgh_conv_sites(len(netgh.residual))}


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
    """GSRNetLow tree -> G_SR_NET_low state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    n_stages = _count(params, "h_net{}", start=1)
    out: StateDict = {
        "ca_net.fc.weight": _t(np.asarray(params["ca_net"]["fc"]["kernel"]).T),
        "ca_net.fc.bias": _t(params["ca_net"]["fc"]["bias"]),
    }
    _put_convs(out, params, netg_conv_sites(
        n_stages, _count(params["h_net1"], "residual_{}")))
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
    return out


def netgh_state_dict(variables: Mapping) -> Tuple[StateDict, float]:
    """NetGHighWeight tree (low 'lr', no weight map) -> (NetG_highweight
    state dict, blend weight a)."""
    params, stats = variables["params"], variables["batch_stats"]
    n_res = _count(params, "residual_{}")
    out: StateDict = {}
    _put_convs(out, params, netgh_conv_sites(n_res))
    _put_bn(out, "convin.1", params["convin"]["bn"], stats["convin"]["bn"])
    for j in range(n_res):
        _put_resblock_bn(out, f"residual.{j}.block", params[f"residual_{j}"],
                         stats[f"residual_{j}"])
    for scale in ("2x", "4x", "8x"):
        _put_bn(out, f"upscale{scale}.2", params[f"upscale{scale}"]["bn"],
                stats[f"upscale{scale}"]["bn"])
    for name in ("residual24", "residual48"):
        _put_resblock_bn(out, name, params[name], stats[name])
    return out, float(np.asarray(params["a"]).reshape(-1)[0])


def text_state_dict(variables: Mapping) -> StateDict:
    """TextEncoder tree (LSTM) -> RNN_ENCODER state dict."""
    params = variables["params"]
    out: StateDict = {"encoder.weight": _t(params["embedding"])}
    for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
        out[f"rnn.weight_ih_l0{suffix}"] = _t(np.asarray(params[f"w_ih_{d}"]).T)
        out[f"rnn.weight_hh_l0{suffix}"] = _t(np.asarray(params[f"w_hh_{d}"]).T)
        out[f"rnn.bias_ih_l0{suffix}"] = _t(params[f"b_ih_{d}"])
        out[f"rnn.bias_hh_l0{suffix}"] = _t(params[f"b_hh_{d}"])
    return out


def state_dicts_from_jax(text_vars: Mapping, netg_vars: Mapping,
                         netgh_vars: Mapping
                         ) -> Tuple[StateDict, StateDict, StateDict, float]:
    """JAX variable trees -> (text_sd, netg_sd, netgh_sd, a)."""
    netgh_sd, a = netgh_state_dict(netgh_vars)
    return text_state_dict(text_vars), netg_state_dict(netg_vars), netgh_sd, a


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
            elif isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(normal(n, 0.1, 1.0))
                m.bias.copy_(normal(n, 0.1))
                m.running_mean.copy_(normal(n, 0.2))
                m.running_var.copy_(uniform(n, 0.5, 2.0))
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(uniform(m.weight.shape, -0.1, 0.1))
            elif isinstance(m, nn.LSTM):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.copy_(uniform(p.shape, -bound, bound))
    return {k: v.clone() for k, v in module.state_dict().items()}


def init_seeded(cfg: Config, vocab_size: int, generator: torch.Generator
                ) -> Tuple[StateDict, StateDict, StateDict, float]:
    """Random weights for the x8 pipeline, made from `generator` on the CPU:
    (text_sd, netg_sd, netgh_sd, a), in the form `state_dicts_from_jax`
    returns. `a` is 0.5, the JAX init."""
    from tgsr_tpu_torch.models.generator import GSRNetLow
    from tgsr_tpu_torch.models.generator_hf import NetGHighWeight
    from tgsr_tpu_torch.models.text_encoder import TextEncoder

    emb = cfg.TEXT.EMBEDDING_DIM
    text = TextEncoder(vocab_size, 300, emb)
    netg = GSRNetLow(cfg.GAN.GF_DIM, emb, cfg.GAN.CONDITION_DIM, cfg.n_stages,
                     cfg.GAN.R_NUM)
    netgh = NetGHighWeight(cfg.GAN.GF_DIM)
    return (_seed_module(text, generator), _seed_module(netg, generator),
            _seed_module(netgh, generator), 0.5)
