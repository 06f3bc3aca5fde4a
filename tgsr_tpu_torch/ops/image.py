"""Image geometry helpers (counterpart of tgsr_tpu/ops/image.py)."""

from __future__ import annotations

from typing import Tuple


def bucket_shape(h: int, w: int, scale: int, bucket: int = 64) -> Tuple[int, int]:
    """(h, w) rounded up to multiples of `bucket` (at least `scale`), so
    that arbitrary-size inputs come in a bounded set of shapes."""
    bucket = max(bucket, scale)
    return -(-h // bucket) * bucket, -(-w // bucket) * bucket
