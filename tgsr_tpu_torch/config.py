"""Configuration (counterpart of tgsr_tpu/config.py).

The JAX package's schema, under the same names and with the same defaults
and strict merge (unknown key -> KeyError, mismatched type -> ValueError, an
int for a float promoted), so that one dict or YAML file builds both.
`check_served` is the one statement of what the port serves (the x8 and x16
families, the LSTM and GRU text encoders, every HF-branch input, weight maps
and stage 1), `check_trained` of what it trains (the same, x8 and x16,
without stage 1) and `check_damsm` of what DAMSM pretraining reads;
`config_from_dict` and every entry point that builds or loads a model call
it, and it raises NotImplementedError on anything else. YAML is
read by the port's own reader of the subset that configs/*.yml use
(`load_yaml`), since the card machine has no PyYAML.

Existing callers build the dataclasses positionally (`TreeConfig(4, 32)`,
`GanConfig(32, 100, 2)`, `TextConfig(256, 18)`), so the fields the serving
forward reads come first in each class; the rest of the schema follows.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple


@dataclass
class TreeConfig:
    # pyramid = BASE_SIZE * 2^(BRANCH_NUM-1); 4 => x8 SR, 5 => x16 SR
    BRANCH_NUM: int = 5
    BASE_SIZE: int = 64


@dataclass
class SmoothConfig:
    GAMMA1: float = 5.0
    GAMMA2: float = 5.0
    GAMMA3: float = 10.0
    LAMBDA: float = 1.0


@dataclass
class TrainConfig:
    BATCH_SIZE: int = 64
    MAX_EPOCH: int = 600
    SNAPSHOT_INTERVAL: int = 2000
    DISCRIMINATOR_LR: float = 2e-4
    GENERATOR_LR: float = 2e-4
    ENCODER_LR: float = 2e-4
    RNN_GRAD_CLIP: float = 0.25
    FLAG: bool = False
    NET_E: str = ""
    NET_G: str = ""
    B_NET_D: bool = True
    SMOOTH: SmoothConfig = field(default_factory=SmoothConfig)


@dataclass
class GanConfig:
    GF_DIM: int = 128
    CONDITION_DIM: int = 100
    R_NUM: int = 2
    DF_DIM: int = 64
    Z_DIM: int = 100
    B_ATTENTION: bool = True
    B_DCGAN: bool = False


@dataclass
class TextConfig:
    EMBEDDING_DIM: int = 256
    WORDS_NUM: int = 18
    CAPTIONS_PER_IMAGE: int = 10


@dataclass
class EvalConfig:
    STAGE1: bool = False
    INPUT_NETGH: str = "lr"  # 'lr' | 'lrblur' | 'lr-lrblur'
    WEIGHTMAP: bool = False
    NO_STOPWORD: bool = False
    ONLY_COLOR: bool = False
    TEXT_BATCH_NUM: int = 100


@dataclass
class Config:
    RNN_TYPE: str = "LSTM"  # 'LSTM' | 'GRU'
    TREE: TreeConfig = field(default_factory=TreeConfig)
    GAN: GanConfig = field(default_factory=GanConfig)
    TEXT: TextConfig = field(default_factory=TextConfig)
    METHOD: str = "S16"
    DATASET_NAME: str = "birds"
    CONFIG_NAME: str = ""
    DATA_DIR: str = ""
    DATA_DIRIM: str = ""
    GPU_ID: int = 0
    CUDA: bool = True
    WORKERS: int = 6
    B_VALIDATION: bool = False
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    EVAL: EvalConfig = field(default_factory=EvalConfig)

    @property
    def scale(self) -> int:
        """SR scale factor: 2^(BRANCH_NUM-1)."""
        return 2 ** (self.TREE.BRANCH_NUM - 1)

    @property
    def imsize(self) -> int:
        """Final output resolution."""
        return self.TREE.BASE_SIZE * self.scale

    @property
    def n_stages(self) -> int:
        """Generator stages = BRANCH_NUM - 1 (each stage up-samples x2)."""
        return self.TREE.BRANCH_NUM - 1

    def pyramid_sizes(self) -> list:
        """[64, 128, 256] for face S8 (BASE_SIZE=32, BRANCH_NUM=4), [64, 128,
        256, 512] for S16 (BRANCH_NUM=5)."""
        return [self.TREE.BASE_SIZE * 2 ** (i + 1) for i in range(self.n_stages)]


def face_s8_config() -> Config:
    """The eval_faceSR geometry: x8 SR of a 32 px face to 256 px, GF_DIM 32,
    R_NUM 2, 18 caption tokens, bi-LSTM text encoder; every other field at
    the schema's default."""
    return Config(TREE=TreeConfig(BRANCH_NUM=4, BASE_SIZE=32), GAN=GanConfig(GF_DIM=32))


# EVAL.INPUT_NETGH, what the HF branch reads: the LR, its blur, or the LR less
# its blur (model.py:267-272; models/generator_hf.py `hf_input`)
SERVED_INPUT_NETGH = ("lr", "lrblur", "lr-lrblur")
# the model families the port serves, by TREE.BRANCH_NUM, as the reference's
# family switch picks them (trainer_objective.py:74-88): 4 the x8 family
# (model.py: GSRNetLow, or GSRNetLowStage1 under EVAL.STAGE1, and
# NetGHighWeight), 5 the x16 family (models16.py: GSRNetLow16,
# NetGHighWeight16; EVAL.STAGE1 not read, as JAX's SRPipeline builds
# GSRNetLow16 whatever it says)
SERVED_BRANCH_NUMS = (4, 5)


# RNN_TYPE, the text encoder's recurrence (models/text_encoder.py RNN_TYPES)
SERVED_RNN_TYPES = ("LSTM", "GRU")


def _check_rnn_type(cfg: Config) -> None:
    if cfg.RNN_TYPE not in SERVED_RNN_TYPES:
        raise NotImplementedError(f"RNN_TYPE = {cfg.RNN_TYPE!r}: the text encoder is one of "
                                  f"{SERVED_RNN_TYPES}")


def check_served(cfg: Config) -> Config:
    """`cfg` as it is, or NotImplementedError naming the setting the port
    does not serve: a BRANCH_NUM outside SERVED_BRANCH_NUMS or an RNN_TYPE
    outside SERVED_RNN_TYPES; ValueError for an EVAL.INPUT_NETGH outside SERVED_INPUT_NETGH
    (JAX's NetGHighWeight raises at its first call). Every EVAL.WEIGHTMAP
    and EVAL.STAGE1 is served, wherever JAX's SRPipeline serves it."""
    if cfg.EVAL.INPUT_NETGH not in SERVED_INPUT_NETGH:
        raise ValueError(f"EVAL.INPUT_NETGH = {cfg.EVAL.INPUT_NETGH!r}: one of "
                         f"{SERVED_INPUT_NETGH}")
    if cfg.TREE.BRANCH_NUM not in SERVED_BRANCH_NUMS:
        raise NotImplementedError(f"TREE.BRANCH_NUM = {cfg.TREE.BRANCH_NUM}: the port serves "
                                  "the x8 (BRANCH_NUM 4) and x16 (BRANCH_NUM 5) families only")
    _check_rnn_type(cfg)
    return cfg


# the families the port trains, by TREE.BRANCH_NUM: the x8 family and the x16
# one (models16's tied modules, called several times in train mode)
TRAINED_BRANCH_NUMS = (4, 5)


def check_trained(cfg: Config) -> Config:
    """`cfg` as it is, or NotImplementedError naming the setting the port
    does not train: what `check_served` refuses (a BRANCH_NUM other than 4
    and 5, an RNN_TYPE other than LSTM and GRU), and EVAL.STAGE1: JAX's GANTrainer never builds
    GSRNetLowStage1 (tgsr_tpu/engine/gan_trainer.py:146-150), it trains
    GSRNetLow whatever STAGE1 says, so a stage-1 run would train another
    model than the one the config names (ROADMAP, Queue C). The blur inputs
    and weight maps train, x8 and x16. The TRAIN fields are the JAX
    schema's, read as the JAX trainer reads them."""
    check_served(cfg)
    if cfg.TREE.BRANCH_NUM not in TRAINED_BRANCH_NUMS:
        raise NotImplementedError(f"TREE.BRANCH_NUM = {cfg.TREE.BRANCH_NUM}: the port trains "
                                  "the x8 (BRANCH_NUM 4) and x16 (BRANCH_NUM 5) families only")
    if cfg.EVAL.STAGE1:
        raise NotImplementedError("EVAL.STAGE1 = True: the port does not train the stage-1 "
                                  "generator (the JAX trainer never builds it and trains "
                                  "GSRNetLow instead)")
    return cfg


def check_damsm(cfg: Config) -> Config:
    """`cfg` as it is, or NotImplementedError: DAMSM pretraining reads any
    tree geometry (its configs are BRANCH_NUM 1 at 299 px) and either text
    encoder, LSTM or GRU (another RNN_TYPE raises, naming it)."""
    _check_rnn_type(cfg)
    return cfg


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    """Every field under the JAX schema's names; the JAX package's
    `config_from_dict` reads it."""
    return dataclasses.asdict(cfg)


def _merge(src: Dict[str, Any], dst: Any, path: str) -> Any:
    """The JAX package's strict merge (`_merge_dict`): unknown keys raise
    KeyError, a mismatched type ValueError (an int for a float is
    promoted; a bool never stands for a number or the reverse)."""
    names = {f.name for f in dataclasses.fields(dst)}
    updates = {}
    for k, v in src.items():
        if k not in names:
            raise KeyError(f"{path}{k} is not a valid config key")
        old = getattr(dst, k)
        if dataclasses.is_dataclass(old):
            if not isinstance(v, dict):
                raise ValueError(f"Type mismatch for config key {path}{k}")
            updates[k] = _merge(v, old, f"{path}{k}.")
            continue
        if isinstance(old, bool) != isinstance(v, bool):
            raise ValueError(f"Type mismatch for config key {path}{k}")
        if isinstance(old, float) and isinstance(v, int):
            v = float(v)
        if type(old) is not type(v):
            raise ValueError(f"Type mismatch ({type(old)} vs {type(v)}) for config key {path}{k}")
        updates[k] = v
    return dataclasses.replace(dst, **updates)


def config_from_dict(d: Dict[str, Any], check: Callable[[Config], Config] = check_served
                     ) -> Config:
    """A Config from a dict of the JAX schema (a YAML file, a bundle's
    config.json), merged over the schema's defaults. Raises
    NotImplementedError on a setting the port does not serve (`check`,
    `check_served` unless the caller names another, as the DAMSM trainer's
    `check_damsm`), KeyError on a key the schema does not have, ValueError
    on a mismatched type."""
    return check(_merge(d, Config(), ""))


def config_from_file(path: str, check: Callable[[Config], Config] = check_served) -> Config:
    """A Config from a YAML file of the schema (configs/*.yml), merged over
    the defaults as `config_from_dict` does."""
    with open(path, encoding="utf-8") as f:
        return config_from_dict(load_yaml(f.read(), path), check)


# -- the YAML subset of configs/*.yml -----------------------------------------

_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(?:\s+(.*))?$")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
# bare words YAML 1.1 reads as something other than a string
_UNSUPPORTED_WORDS = {"null", "Null", "NULL", "~", "yes", "Yes", "YES", "no", "No", "NO",
                      "on", "On", "ON", "off", "Off", "OFF", "y", "Y", "n", "N"}


def _strip_comment(text: str, where: str) -> str:
    """`text` up to a comment (a '#' after whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    if quote:
        raise ValueError(f"{where}: unterminated quoted string")
    return text.rstrip()


def _scalar(text: str, where: str) -> Any:
    if text[0] in "'\"":
        q = text[0]
        if len(text) < 2 or text[-1] != q:
            raise ValueError(f"{where}: text after a quoted string")
        body = text[1:-1]
        if q == "'":
            if re.search(r"(?<!')'(?!')", body.replace("''", "")):
                raise ValueError(f"{where}: stray quote in a single-quoted string")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in double-quoted strings are not supported")
        return body
    if (text[0] in "[{&*!|>%@`" or text in _UNSUPPORTED_WORDS
            or text[0] in "-?:" and (len(text) == 1 or text[1] == " ")):
        raise ValueError(f"{where}: {text!r} is outside the supported YAML subset "
                         "(mappings of plain scalars only)")
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if re.match(r"[-+]?\.?[0-9]", text):
        raise ValueError(f"{where}: {text!r}: write numbers as plain decimals")
    return text


def load_yaml(text: str, name: str = "<yaml>") -> Dict[str, Any]:
    """The YAML subset of the repository's configs as nested dicts:
    indentation-nested mappings, single- or double-quoted and bare strings,
    ints, floats, True / False, full-line and trailing comments. Anything
    else (lists, flow style, anchors, block scalars, tabs, null) raises
    ValueError with the line number."""
    root: Dict[str, Any] = {}
    # (indent, mapping) from the outermost; `pending` a key awaiting its block
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]
    pending = None
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = _strip_comment(raw, where)
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tab in indentation")
        indent = len(line) - len(line.lstrip(" "))
        if pending is not None:
            parent_indent, key, mapping = pending
            if indent <= parent_indent:
                raise ValueError(f"{where}: key {key!r} has no value")
            stack.append((indent, mapping))
            pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        m = _KEY.match(line.strip())
        if not m:
            raise ValueError(f"{where}: expected 'KEY: value' (the supported YAML subset is "
                             "mappings of plain scalars)")
        key, value = m.group(1), m.group(2)
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if value:
            mapping[key] = _scalar(value, where)
        else:
            mapping[key] = {}
            pending = (indent, key, mapping[key])
    if pending is not None:
        raise ValueError(f"{name}: key {pending[1]!r} at the end has no value")
    return root
