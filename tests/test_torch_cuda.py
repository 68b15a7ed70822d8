"""The port's CUDA kernels on a card, against their plain versions.

Marked ``cuda``; each test skips without a card.  This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from r2d2dpg_torch.kernels import PRIORITY_SCATTER
from r2d2dpg_torch.ops.scatter import priority_scatter, priority_scatter_plain


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,b", [(100_000, 64), (50_000, 256), (300, 64)])
def test_priority_scatter_kernel_matches_plain_exactly(capacity, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(b)
    prio = rng.uniform(0.1, 2.0, capacity).astype(np.float32)
    idx = rng.integers(0, capacity, b).astype(np.int64)
    idx[b // 2] = idx[0]  # duplicates: the later one wins
    idx[2] = capacity + 5  # out of range: writes nothing
    idx[3] = -1
    vals = rng.uniform(3.0, 9.0, b).astype(np.float32)
    want = priority_scatter_plain(
        torch.from_numpy(prio.copy()), torch.from_numpy(idx), torch.from_numpy(vals)
    )
    dev = torch.device("cuda")
    got = torch.from_numpy(prio).to(dev)
    before = PRIORITY_SCATTER.launches
    priority_scatter(got, torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev))
    torch.cuda.synchronize()
    assert PRIORITY_SCATTER.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
