"""The inputs that the benchmark makes and hands to the program and to the
reference alike, from the seed (``np.random.default_rng``, which takes
any non-negative whole number)."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed."""
    return np.random.default_rng([int(seed), int(stream)])


def tone_pool(n: int, seconds: float, base_hz: float, amp: float,
              rate: int) -> list[np.ndarray]:
    """``n`` sine tones a semitone apart from ``base_hz``, mono float32."""
    t = np.arange(int(round(seconds * rate))) / rate
    return [(amp * np.sin(2 * np.pi * base_hz * 2.0 ** (i / 12.0) * t)
             ).astype(np.float32) for i in range(n)]
