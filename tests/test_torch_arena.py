"""Port parity: r2d2dpg_torch.replay and the priority scatter against JAX.

- ``add`` and ``sample``: the same batches and priorities go into both
  arenas; sampling gets the uniforms JAX drew for its own sample, so both
  must pick the same slots (probabilities to rtol 1e-6).
- The scatter's plain version against the Pallas kernel run by the Pallas
  interpreter (``_pallas_scatter(..., interpret=True)``), with duplicate
  indices inside one warp and across warps of the CUDA kernel's block, every
  index the same, every index out of range, batches that are not a multiple
  of 32 and capacities that are not a multiple of 128
  (``r2d2dpg_torch.testing.scatter_case``).  That comparison is exact: both
  only copy values.
- The kernel's launch shape and its batch and capacity limits, which the
  wrapper computes and checks in Python on every device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.ops.pallas.scatter import _pallas_scatter
from r2d2dpg_tpu.replay.arena import ReplayArena as JArena
from r2d2dpg_tpu.replay.arena import SequenceBatch as JBatch
from r2d2dpg_torch.convert import sequence_batch_from_jax
from r2d2dpg_torch.ops.scatter import (
    MAX_BATCH,
    MAX_CAPACITY,
    MAX_THREADS,
    _launch_shape,
    priority_scatter,
)
from r2d2dpg_torch.replay import ReplayArena
from r2d2dpg_torch.testing import scatter_case

L, OBS, ACT, HID = 6, 3, 2, 4


def _jbatch(rng, b):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return JBatch(
        obs=jnp.asarray(f(b, L, OBS)),
        action=jnp.asarray(f(b, L, ACT)),
        reward=jnp.asarray(f(b, L)),
        discount=jnp.ones((b, L)),
        reset=jnp.asarray((rng.random((b, L)) < 0.2).astype(np.float32)),
        carries={"actor": (jnp.asarray(f(b, HID)), jnp.asarray(f(b, HID))),
                 "critic": (jnp.asarray(f(b, HID)), jnp.asarray(f(b, HID)))},
    )


def _leaves_equal(t_batch, j_batch):
    """Every leaf equal, in the JAX dataclass's field order (carries by key)."""
    b = t_batch
    ours = [b.obs, b.action, b.reward, b.discount, b.reset,
            *b.carries["actor"], *b.carries["critic"]]
    for mine, theirs in zip(ours, jax.tree_util.tree_leaves(jax.device_get(j_batch)),
                            strict=True):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("capacity", [37, 300])
def test_add_and_prioritized_sample_match_jax(capacity):
    rng = np.random.default_rng(0)
    jarena = JArena(capacity, prioritized=True, alpha=0.6)
    tarena = ReplayArena(capacity, prioritized=True, alpha=0.6)
    first = _jbatch(rng, 16)
    jstate = jarena.init_state(first)
    tstate = tarena.init_state(sequence_batch_from_jax(jax.device_get(first)))
    # Three adds wrap the ring at capacity 37; priorities include values under
    # PRIORITY_EPS (clamped) and a stamped meta on one add.
    for i, b in enumerate((16, 16, 9)):
        batch = _jbatch(rng, b)
        prios = rng.uniform(-0.5, 3.0, b).astype(np.float32)
        meta = None if i != 1 else np.full((b, 2), 7, np.int32)
        jstate = jarena.add(jstate, batch, jnp.asarray(prios),
                            meta=None if meta is None else jnp.asarray(meta))
        tarena.add(tstate, sequence_batch_from_jax(jax.device_get(batch)),
                   torch.from_numpy(prios),
                   meta=None if meta is None else torch.from_numpy(meta))
    np.testing.assert_array_equal(tstate.priority.numpy(), np.asarray(jstate.priority))
    np.testing.assert_array_equal(tstate.meta.numpy(), np.asarray(jstate.meta))
    assert tstate.cursor == int(jstate.cursor)
    assert tstate.total_added == int(jstate.total_added)
    assert tarena.size(tstate) == int(jarena.size(jstate))
    _leaves_equal(tstate.data, jstate.data)

    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        res_j = jarena.sample(jstate, key, 64)
        u = jax.random.uniform(key, (64,))  # what JAX drew inside sample()
        res_t = tarena.sample(tstate, 64, uniforms=torch.tensor(np.asarray(u)))
        np.testing.assert_array_equal(res_t.indices.numpy(), np.asarray(res_j.indices))
        np.testing.assert_allclose(res_t.probs.numpy(), np.asarray(res_j.probs),
                                   rtol=1e-6)
        _leaves_equal(res_t.batch, res_j.batch)


def test_uniform_sampling_stays_in_the_valid_prefix():
    rng = np.random.default_rng(1)
    arena = ReplayArena(50, prioritized=False)
    batch = sequence_batch_from_jax(jax.device_get(_jbatch(rng, 10)))
    state = arena.init_state(batch)
    arena.add(state, batch, torch.ones(10))
    res = arena.sample(state, 512, generator=torch.Generator().manual_seed(0))
    assert 0 <= int(res.indices.min()) and int(res.indices.max()) < 10
    np.testing.assert_allclose(res.probs.numpy(), 0.1, rtol=1e-6)
    assert res.batch.obs.shape == (512, L, OBS)


_SCATTER_CASES = [
    # (capacity, b, pattern); the first four keep their original ids.
    pytest.param(300, 64, "mixed", id="300-64"),
    pytest.param(300, 256, "mixed", id="300-256"),
    pytest.param(8, 8, "mixed", id="8-8"),
    pytest.param(1024, 64, "mixed", id="1024-64"),
    # one slot at j = 0, 31, 32, 95, 255: within a warp and across warps
    pytest.param(300, 256, "repeat", id="repeat-300-256"),
    pytest.param(1024, 100, "repeat", id="repeat-1024-100"),
    pytest.param(300, 64, "all_same", id="all_same-300-64"),
    pytest.param(300, 33, "all_same", id="all_same-300-33"),
    pytest.param(300, 64, "out_of_range", id="out_of_range-300-64"),
    pytest.param(1024, 33, "out_of_range", id="out_of_range-1024-33"),
    # B not a multiple of 32: the kernel's ragged last warp
    pytest.param(300, 33, "mixed", id="mixed-300-33"),
    pytest.param(1024, 100, "mixed", id="mixed-1024-100"),
]


@pytest.mark.parametrize("capacity,b,pattern", _SCATTER_CASES)
def test_scatter_plain_matches_pallas_kernel_exactly(capacity, b, pattern):
    prio, idx, vals = scatter_case(pattern, capacity, b, seed=capacity + b)
    want = _pallas_scatter(
        jnp.asarray(prio), jnp.asarray(idx.astype(np.int32)), jnp.asarray(vals),
        interpret=True,
    )
    got = torch.from_numpy(prio.copy())
    out = priority_scatter(got, torch.from_numpy(idx), torch.from_numpy(vals))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # last write wins, out-of-range skipped
    last = {int(s): j for j, s in enumerate(idx) if 0 <= s < capacity}
    for slot, j in last.items():
        assert got[slot] == vals[j]
    if pattern == "out_of_range":
        np.testing.assert_array_equal(got.numpy(), prio)


@pytest.mark.parametrize(
    "b,blocks,threads",
    [(1, 1, 32), (31, 1, 32), (32, 1, 32), (33, 1, 64), (64, 1, 64), (65, 1, 96),
     (256, 1, 256), (1024, 1, 1024), (1025, 2, 1024), (4096, 4, 1024)],
)
def test_launch_shape_sizes_one_block_to_the_batch(b, blocks, threads):
    # Whole warps, one update a thread; one block up to 1,024 updates, then
    # blocks of 1,024.
    assert threads % 32 == 0 and threads <= MAX_THREADS
    assert (blocks - 1) * threads < b <= blocks * threads
    assert _launch_shape(b) == (blocks, threads)


def test_scatter_batch_limit_raises_value_error():
    # The kernel counts updates in 32-bit ints; meta tensors stand in for
    # batches of 16 GB of indices.
    assert MAX_BATCH + MAX_THREADS < 2**31
    p = torch.empty(10, device="meta")
    for n, error in ((MAX_BATCH + 1, "32-bit ints"), (MAX_BATCH, "unsupported device")):
        with pytest.raises(ValueError, match=error):
            priority_scatter(
                p, torch.zeros(n, dtype=torch.int64, device="meta"),
                torch.zeros(n, device="meta"),
            )
    # Far below the limit it runs; slot k keeps the last j with j % 10 == k.
    p = torch.zeros(10)
    j = np.arange(8192)
    priority_scatter(p, torch.from_numpy(j % 10), torch.from_numpy(j.astype(np.float32)))
    want = np.array([j[j % 10 == k].max() for k in range(10)], np.float32)
    np.testing.assert_array_equal(p.numpy(), want)


def test_scatter_capacity_limit_raises_value_error():
    # The kernel compares 32-bit keys, as the JAX kernel's int32 indices; a
    # meta tensor stands in for an 8 GB priority vector.
    idx = torch.zeros(2, dtype=torch.int64, device="meta")
    vals = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        priority_scatter(torch.empty(MAX_CAPACITY + 1, device="meta"), idx, vals)
    with pytest.raises(ValueError, match="unsupported device"):
        priority_scatter(torch.empty(MAX_CAPACITY, device="meta"), idx, vals)


def test_update_priorities_matches_jax_arena():
    rng = np.random.default_rng(3)
    jarena, tarena = JArena(300), ReplayArena(300)
    batch = _jbatch(rng, 300)
    prios = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    jstate = jarena.add(jarena.init_state(batch), batch, jnp.asarray(prios))
    tb = sequence_batch_from_jax(jax.device_get(batch))
    tstate = tarena.add(tarena.init_state(tb), tb, torch.from_numpy(prios))
    _, idx, vals = scatter_case("mixed", 300, 64, seed=4)
    idx[2], idx[3] = 17, 18  # JAX's arena takes in-range slots only
    vals[5] = -1.0  # clamped to PRIORITY_EPS
    jstate = jarena.update_priorities(
        jstate, jnp.asarray(idx.astype(np.int32)), jnp.asarray(vals)
    )
    tarena.update_priorities(tstate, torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(tstate.priority.numpy(), np.asarray(jstate.priority))


def test_scatter_wrapper_rejects_what_the_kernel_does_not_take():
    p = torch.zeros(10)
    with pytest.raises(TypeError):
        priority_scatter(p, torch.zeros(2, dtype=torch.int32), torch.zeros(2))
    with pytest.raises(TypeError):
        priority_scatter(p.double(), torch.zeros(2, dtype=torch.int64), torch.zeros(2))
    with pytest.raises(ValueError):
        priority_scatter(p, torch.zeros(2, dtype=torch.int64), torch.zeros(3))
    with pytest.raises(ValueError):
        priority_scatter(
            torch.zeros(10, 2)[:, 0], torch.zeros(2, dtype=torch.int64), torch.zeros(2)
        )
