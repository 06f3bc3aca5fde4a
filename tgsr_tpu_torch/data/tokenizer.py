"""Caption vocabulary (counterpart of tgsr_tpu/data/tokenizer.py `Vocab`):
what `SRPipeline.load_artifact` returns for a bundled vocab.json."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence


@dataclass
class Vocab:
    ixtoword: Dict[int, str]
    wordtoix: Dict[str, int]

    @property
    def n_words(self) -> int:
        return len(self.ixtoword)

    def encode_tokens(self, tokens: Sequence[str]) -> List[int]:
        return [self.wordtoix[w] for w in tokens if w in self.wordtoix]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.ixtoword[int(i)] for i in ids if int(i) in self.ixtoword]
