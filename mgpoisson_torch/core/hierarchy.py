"""Grid hierarchy bookkeeping (port of ``mgpoisson/core/hierarchy.py``):
the level sides fine -> coarse and their spacings."""

from __future__ import annotations

from typing import List


def num_levels(size: int, coarse_size: int = 1) -> int:
    """Number of levels from side `size` down to side `coarse_size` inclusive."""
    return len(level_sizes(size, coarse_size))


def level_sizes(size: int, coarse_size: int = 1) -> List[int]:
    """Side lengths fine -> coarse: [size, size/2, ..., coarse_size]."""
    out = [size]
    while out[-1] > coarse_size:
        out.append(out[-1] // 2)
    return out


def level_spacings(size: int, fine_h: float, coarse_size: int = 1) -> List[float]:
    """Grid spacing per level; h doubles as the side halves."""
    return [fine_h * (2 ** i) for i in range(num_levels(size, coarse_size))]

