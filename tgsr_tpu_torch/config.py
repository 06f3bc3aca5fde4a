"""Configuration subset for the PyTorch port (counterpart of tgsr_tpu/config.py).

Only the fields and derived geometry that the x8 face-SR serving forward
reads are kept, under the same names as the JAX package's dataclasses, so a
config dict builds both. No YAML loading: the port is configured in code.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
