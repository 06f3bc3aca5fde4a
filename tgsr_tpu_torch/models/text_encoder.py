"""Bidirectional LSTM / GRU text encoder (counterpart of
tgsr_tpu/models/text_encoder.py; = RNN_ENCODER, util.py:175-260), the
recurrence chosen by `rnn_type` (cfg.RNN_TYPE).

The recurrence is a masked loop over the T caption slots, as the JAX
package's masked scan: the forward direction stops updating at t >= len,
the backward direction treats t >= len as no-ops, and word outputs are zero
beyond len. No sorting, and no `pack_padded_sequence`, which rejects the
len == 0 of an empty caption. The `nn.LSTM` / `nn.GRU` only holds the
weights, under the reference's state-dict names (`rnn.weight_ih_l0[_reverse]`,
...; [4H, .] for the LSTM, gates i, f, g, o; [3H, .] for the GRU, gates
r, z, n) and is never called.

In train mode (`module.train()`, the DAMSM trainer) the embeddings go
through inverted dropout at `drop_prob` (0.5, util.py:183), as flax's
`nn.Dropout`: each entry kept with probability 1 - p and scaled by
1 / (1 - p). The keep mask is drawn on the CPU from the caller's
`torch.Generator` and then moved, so that a seeded step draws the same mask
on the card and on the CPU. Eval mode (serving, the GAN trainer's frozen
encoder) never draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def _masked_lstm(xs, lens, w_ih, w_hh, b, reverse: bool):
    """xs [B, T, I], lens [B] -> (outputs [B, T, H] zero-padded, final h [B, H]).
    Gate order i, f, g, o (torch convention)."""
    bsz, steps, _ = xs.shape
    hidden = w_hh.shape[1]
    xw = xs @ w_ih.t() + b  # [B, T, 4H], input projection for every step
    h = xs.new_zeros(bsz, hidden)
    c = xs.new_zeros(bsz, hidden)
    outs = [None] * steps
    for t in (reversed(range(steps)) if reverse else range(steps)):
        i, f, g, o = (xw[:, t] + h @ w_hh.t()).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (t < lens)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs[t] = torch.where(valid, h_new, torch.zeros_like(h_new))
    return torch.stack(outs, dim=1), h


def _masked_gru(xs, lens, w_ih, w_hh, b_ih, b_hh, reverse: bool):
    """The GRU counterpart of `_masked_lstm` (JAX's `_masked_gru`). Gate
    order r, z, n (torch convention). Only b_ih joins the input projection:
    b_hn sits inside r * (h @ W_hn + b_hn), so the two biases do not fold."""
    bsz, steps, _ = xs.shape
    hidden = w_hh.shape[1]
    xw = xs @ w_ih.t() + b_ih  # [B, T, 3H], input projection for every step
    h = xs.new_zeros(bsz, hidden)
    outs = [None] * steps
    for t in (reversed(range(steps)) if reverse else range(steps)):
        i_r, i_z, i_n = xw[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n + z * h
        valid = (t < lens)[:, None]
        h = torch.where(valid, h_new, h)
        outs[t] = torch.where(valid, h_new, torch.zeros_like(h_new))
    return torch.stack(outs, dim=1), h


# cfg.RNN_TYPE -> the torch module that holds the weights
RNN_TYPES = {"LSTM": nn.LSTM, "GRU": nn.GRU}


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """Inverted dropout as flax's `nn.Dropout`: keep an entry with
    probability 1 - p and scale it by 1 / (1 - p), else 0. The mask is drawn
    on the CPU from `generator` (the default generator when None)."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class TextEncoder(nn.Module):
    """RNN_ENCODER(ntoken, ninput=300, nhidden) with a bidirectional LSTM or
    GRU (`rnn_type`, cfg.RNN_TYPE; another value raises NotImplementedError
    naming it, as JAX's TextEncoder does); the per-direction hidden size is
    nhidden // 2 (util.py:191)."""

    def __init__(self, vocab_size: int, emb_dim: int = 300, nhidden: int = 256,
                 drop_prob: float = 0.5, rnn_type: str = "LSTM"):
        super().__init__()
        if rnn_type not in RNN_TYPES:
            raise NotImplementedError(rnn_type)
        self.drop_prob = drop_prob
        self.rnn_type = rnn_type
        self.encoder = nn.Embedding(vocab_size, emb_dim)
        self.rnn = RNN_TYPES[rnn_type](emb_dim, nhidden // 2, 1, batch_first=True,
                                       bidirectional=True)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """captions [B, T] token ids (0 = pad), cap_lens [B] ->
        (words [B, T, nhidden], sent [B, nhidden]); the feature axis is
        [forward half, backward half]. `generator` (a CPU generator) draws
        the train-mode dropout mask."""
        emb = self.encoder(captions)
        if self.training and self.drop_prob > 0:
            emb = dropout(emb, self.drop_prob, generator)
        outs, finals = [], []
        for suffix, reverse in (("", False), ("_reverse", True)):
            p = {n: getattr(self.rnn, f"{n}_l0{suffix}")
                 for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            if self.rnn_type == "LSTM":
                o, hf = _masked_lstm(emb, cap_lens, p["weight_ih"], p["weight_hh"],
                                     p["bias_ih"] + p["bias_hh"], reverse)
            else:
                o, hf = _masked_gru(emb, cap_lens, p["weight_ih"], p["weight_hh"],
                                    p["bias_ih"], p["bias_hh"], reverse)
            outs.append(o)
            finals.append(hf)
        return torch.cat(outs, dim=-1), torch.cat(finals, dim=-1)
