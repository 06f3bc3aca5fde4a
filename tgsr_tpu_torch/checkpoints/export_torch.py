"""Flax variable trees -> reference `.pth` state dicts (counterpart of
tgsr_tpu/checkpoints/export_torch.py, with its key sets and rules).

The way back to the reference's stack: the msgpack snapshots that
`cli.train_gan` and `cli.pretrain_damsm` write (flax trees, read by
`msgpack_io.load_variables`) become state dicts under the reference's key
names and layouts, which the reference's torch modules, and the port's,
load with `strict=True`. The netG and text-encoder files are
`from_jax.netg_state_dict` and `text_state_dict` as they are (conv HWIO ->
OIHW, Dense [in, out] -> [out, in], the word projection -> a 1x1
conv_context, BN -> weight / bias / running stats with a
num_batches_tracked of 0; an x16 netG carries every alias key set of its
tied stage and head, h_net2/3/4 and img_net1..4, models16.py:13-14); this
module adds JAX's export rules for the rest:

- the blend weight `a` of NetG_highweight is not a registered parameter of
  the reference (model.py:246-248), so it is dropped; the weight map's
  a1..a4 are, and export where `weightmap` is set and the tree has them;
- an x16 netGH exports residual816 / upscale16x exactly where the tree
  carries them (the reference declares them and never runs them,
  models16.py:171-173);
- only an Inception-family image encoder exports: the reference has no
  module for the SimpleCNN encoder, which is refused with the reason.
"""

from __future__ import annotations

from typing import Mapping

from tgsr_tpu_torch.checkpoints.from_jax import (WEIGHT_MAPS, StateDict, _t,
                                                 cnn_encoder_state_dict,
                                                 netgh_conv_bn_state_dict)


def export_netgh(variables: Mapping, weightmap: bool = False) -> StateDict:
    """A NetGHighWeight (x8) or NetGHighWeight16 (x16) tree -> the reference
    netGH state dict, without `a`; with `weightmap`, the tree's a1..a4."""
    out = netgh_conv_bn_state_dict(variables)
    if weightmap:
        params = variables["params"]
        out.update({n: _t(params[n]) for n in WEIGHT_MAPS if n in params})
    return out


def export_cnn_encoder(variables: Mapping) -> StateDict:
    """An Inception-family CNNEncoder tree -> the CNN_ENCODER state dict
    (util.py:263-368; the backbone under torchvision's inception_v3 names).
    Raises for a SimpleCNN tree: the reference has no module to load it."""
    if "inception" not in variables["params"]:
        raise ValueError("not an Inception-family image-encoder tree (SimpleCNNEncoder "
                         "snapshots have no reference torch counterpart to export to)")
    return cnn_encoder_state_dict(variables)

