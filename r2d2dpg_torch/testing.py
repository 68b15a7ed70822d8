"""Inputs shared by the port's tests and ``chip_smoke.py``.

``scatter_case`` builds the priority-scatter inputs whose duplicates fall
inside one warp and across warps of the kernel's block, so the CPU tests
(against the JAX reference), the card tests and the chip smoke run hold the
kernel to the same patterns.
"""

from __future__ import annotations

import numpy as np

SCATTER_PATTERNS = ("mixed", "repeat", "all_same", "out_of_range")
# "repeat" writes one slot at these j (those below B): within warp 0
# (0, 31), then the next warps (32, 95, 255); the last one must win.
REPEAT_AT = (0, 31, 32, 95, 255)


def scatter_case(pattern: str, capacity: int, b: int, seed: int):
    """numpy (priority [capacity] f32, indices [b] int64, values [b] f32).

    Every pattern starts from random in-range indices and distinct-looking
    values (so which duplicate won is visible), then:

    - ``mixed``: index ``b//2`` repeats index 0 and the last repeats index 1
      (the later one wins); indices 2 and 3 lie above and below the range;
    - ``repeat``: one slot at every ``REPEAT_AT`` position below ``b``;
    - ``all_same``: every index the same slot;
    - ``out_of_range``: every index outside ``[0, capacity)``, alternately
      above and below.
    """
    rng = np.random.default_rng(seed)
    prio = rng.uniform(0.1, 2.0, capacity).astype(np.float32)
    idx = rng.integers(0, capacity, b).astype(np.int64)
    vals = rng.uniform(3.0, 9.0, b).astype(np.float32)
    if pattern == "mixed":
        if b >= 2:
            idx[b // 2] = idx[0]
            idx[-1] = idx[1]
        if b >= 4:
            idx[2] = capacity + 5
            idx[3] = -1
    elif pattern == "repeat":
        idx[[j for j in REPEAT_AT if j < b]] = idx[0]
    elif pattern == "all_same":
        idx[:] = idx[0]
    elif pattern == "out_of_range":
        j = np.arange(b, dtype=np.int64)
        idx = np.where(j % 2 == 0, capacity + j, -1 - j)
    else:
        raise ValueError(f"unknown scatter pattern {pattern!r}")
    return prio, idx, vals
