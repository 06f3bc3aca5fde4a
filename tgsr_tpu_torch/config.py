"""Configuration subset for the PyTorch port (counterpart of tgsr_tpu/config.py).

Only the fields and derived geometry that the x8 face-SR serving forward
reads are kept, under the same names as the JAX package's dataclasses, so a
config dict builds both. No YAML loading: the port is configured in code, or
from the JSON dict of a deployment bundle (`config_to_dict`,
`config_from_dict`, the JAX package's schema).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class TreeConfig:
    # pyramid = BASE_SIZE * 2^(BRANCH_NUM-1); 4 => x8 SR
    BRANCH_NUM: int = 4
    BASE_SIZE: int = 32


@dataclass
class GanConfig:
    GF_DIM: int = 32
    CONDITION_DIM: int = 100
    R_NUM: int = 2


@dataclass
class TextConfig:
    EMBEDDING_DIM: int = 256
    WORDS_NUM: int = 18


@dataclass
class Config:
    RNN_TYPE: str = "LSTM"
    TREE: TreeConfig = field(default_factory=TreeConfig)
    GAN: GanConfig = field(default_factory=GanConfig)
    TEXT: TextConfig = field(default_factory=TextConfig)

    @property
    def scale(self) -> int:
        """SR scale factor: 2^(BRANCH_NUM-1)."""
        return 2 ** (self.TREE.BRANCH_NUM - 1)

    @property
    def n_stages(self) -> int:
        """Generator stages = BRANCH_NUM - 1 (each stage up-samples x2)."""
        return self.TREE.BRANCH_NUM - 1

    def pyramid_sizes(self) -> list:
        """[64, 128, 256] for face S8 (BASE_SIZE=32, BRANCH_NUM=4)."""
        return [self.TREE.BASE_SIZE * 2 ** (i + 1) for i in range(self.n_stages)]


def face_s8_config() -> Config:
    """The eval_faceSR geometry: x8 SR of a 32 px face to 256 px, GF_DIM 32,
    R_NUM 2, 18 caption tokens, bi-LSTM text encoder."""
    return Config(
        RNN_TYPE="LSTM",
        TREE=TreeConfig(BRANCH_NUM=4, BASE_SIZE=32),
        GAN=GanConfig(GF_DIM=32, CONDITION_DIM=100, R_NUM=2),
        TEXT=TextConfig(EMBEDDING_DIM=256, WORDS_NUM=18),
    )


# the EVAL settings of the JAX schema the port serves, and only these
# (SRPipeline: GSRNetLow, NetGHighWeight on the LR, no weight map)
SERVED_EVAL = {"STAGE1": False, "INPUT_NETGH": "lr", "WEIGHTMAP": False}
# the JAX schema's fields that do not change the serving forward (data,
# training and evaluation settings); config_from_dict accepts and ignores them
IGNORED = {
    "": {"METHOD", "DATASET_NAME", "CONFIG_NAME", "DATA_DIR", "DATA_DIRIM", "GPU_ID", "CUDA",
         "WORKERS", "B_VALIDATION", "TRAIN"},
    "GAN": {"DF_DIM", "Z_DIM", "B_ATTENTION", "B_DCGAN"},
    "TEXT": {"CAPTIONS_PER_IMAGE"},
    "EVAL": {"NO_STOPWORD", "ONLY_COLOR", "TEXT_BATCH_NUM"},
}


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    """The port's fields under the JAX schema's names, with the EVAL
    settings it serves; the JAX package's `config_from_dict` reads it."""
    return {**dataclasses.asdict(cfg), "EVAL": dict(SERVED_EVAL)}


def _merge(src: Dict[str, Any], dst: Any, path: str) -> Any:
    """The JAX package's strict merge rule (`_merge_dict`) over the port's
    fields: unknown keys raise KeyError, a mismatched type ValueError (an
    int for a float is promoted)."""
    names = {f.name for f in dataclasses.fields(dst)}
    updates = {}
    for k, v in src.items():
        if k in IGNORED.get(path.rstrip("."), ()):
            continue
        if k not in names:
            raise KeyError(f"{path}{k} is not a valid config key")
        old = getattr(dst, k)
        if dataclasses.is_dataclass(old):
            if not isinstance(v, dict):
                raise ValueError(f"Type mismatch for config key {path}{k}")
            updates[k] = _merge(v, old, f"{path}{k}.")
            continue
        if isinstance(old, float) and type(v) is int:
            v = float(v)
        if type(old) is not type(v):
            raise ValueError(f"Type mismatch ({type(old)} vs {type(v)}) for config key {path}{k}")
        updates[k] = v
    return dataclasses.replace(dst, **updates)


def config_from_dict(d: Dict[str, Any]) -> Config:
    """A Config from a dict of the JAX schema (a bundle's config.json, the
    full schema included), merged over the port's defaults. Raises
    NotImplementedError on a setting the port does not serve (BRANCH_NUM
    other than 4, a GRU, a stage-1 generator, a blurred HF input, a weight
    map), KeyError on a key the JAX schema does not have."""
    d = dict(d)
    evals = dict(d.pop("EVAL", {}))
    for k, v in evals.items():
        if k in IGNORED["EVAL"]:
            continue
        if k not in SERVED_EVAL:
            raise KeyError(f"EVAL.{k} is not a valid config key")
        if v != SERVED_EVAL[k]:
            raise NotImplementedError(f"EVAL.{k} = {v!r}: the port serves "
                                      f"EVAL.{k} = {SERVED_EVAL[k]!r} only")
    cfg = _merge(d, Config(), "")
    if cfg.TREE.BRANCH_NUM != 4:
        raise NotImplementedError(f"TREE.BRANCH_NUM = {cfg.TREE.BRANCH_NUM}: the port serves "
                                  "the x8 family (BRANCH_NUM 4) only")
    if cfg.RNN_TYPE != "LSTM":
        raise NotImplementedError(f"RNN_TYPE = {cfg.RNN_TYPE!r}: the port's text encoder is "
                                  "the LSTM")
    return cfg
