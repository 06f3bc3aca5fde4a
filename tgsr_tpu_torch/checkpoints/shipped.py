"""The shipped trained face NET_E and the text-encoder resolution of the
eval and serving CLIs (counterpart of tgsr_tpu/checkpoints/shipped.py).

The trained face NET_E is a data file of the JAX package,
tgsr_tpu/checkpoints/face_net_e_s8.{msgpack,json}; the port reads it by path
(checkpoints/msgpack_io.py), beside this package in the repository.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

SHIPPED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tgsr_tpu", "checkpoints")


def shipped_net_e(vocab_size: int, rnn_type: str = "LSTM") -> Optional[str]:
    """Path of the shipped trained face NET_E when its vocabulary has
    `vocab_size` words and its recurrence is `rnn_type` (its .json sidecar
    says both; it is an LSTM), else None. JAX's reads the vocabulary only,
    and so hands a GRU config an LSTM file its GRU encoder cannot apply."""
    path = os.path.join(SHIPPED_DIR, "face_net_e_s8.msgpack")
    meta_path = path.replace(".msgpack", ".json")
    if not (os.path.isfile(path) and os.path.isfile(meta_path)):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("vocab_size") != vocab_size or meta.get("rnn_type", "LSTM") != rnn_type:
        return None
    return path


def resolve_net_e(cfg, explicit: str, vocab_size: int,
                  seeded: bool = False) -> Tuple[Optional[str], str]:
    """The text encoder's source for an eval or serving CLI, as (path or
    None, a description), by priority:
      1. `seeded` (--seeded-text): None, the seeded init;
      2. `explicit` (--text_encoder): the user's file;
      3. cfg.TRAIN.NET_E, when set and present on disk;
      4. the shipped trained face NET_E, when its vocabulary and its
         recurrence (cfg.RNN_TYPE) match;
      5. None: the seeded init."""
    if seeded:
        return None, "seeded (--seeded-text)"
    if explicit:
        return explicit, f"--text_encoder {explicit}"
    cfg_path = getattr(getattr(cfg, "TRAIN", None), "NET_E", "") or ""
    if cfg_path:
        if os.path.exists(cfg_path):
            return cfg_path, f"cfg NET_E {cfg_path}"
        print(f"[net_e] cfg NET_E {cfg_path!r} not found on disk; falling through", flush=True)
    shipped = shipped_net_e(vocab_size, getattr(cfg, "RNN_TYPE", "LSTM"))
    if shipped:
        return shipped, f"shipped trained NET_E ({shipped})"
    return None, "seeded init (no NET_E source available)"
