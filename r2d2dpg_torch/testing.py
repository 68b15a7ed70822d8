"""Inputs shared by the port's tests and ``chip_smoke.py``.

``scatter_case`` builds the priority-scatter inputs whose duplicates fall
inside one warp and across warps of the kernel's block, so the CPU tests
(against the JAX reference), the card tests and the chip smoke run hold the
kernel to the same patterns.  ``lstm_seq_errors`` holds the LSTM
recurrence kernel (``ops/lstm_seq.py``) to its plain version at one of
``LSTM_SEQ_SHAPES``, for the card tests, the chip smoke run and
``probes/lstm_seq.py``.  ``HostStandInEnv`` is a host-stepped env
with walker-walk's spec and fixed numpy dynamics, which drives the
host-pool trainer (``parallel/hybrid.py``) where there is no MuJoCo.
``count_collectives`` counts the ``torch.distributed`` collectives each
thread calls, which shows that the pipelined collector calls none.
"""

from __future__ import annotations

import collections
import contextlib
import threading

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


# (label, E, T, B, H): the recurrence's shapes on the repo's configs'
# learner paths (E ensemble members: fused burn-in 2, TD3's 4, its twin
# critics 2), a humanoid window of 85 steps, and the batch's edges: one
# row, a ragged cluster, and batches past the card's SMs (a learner's
# ``--batch-size`` or the entry priorities' ``--num-envs``), whose clusters
# run in waves.
LSTM_SEQ_SHAPES = (
    ("walker_unroll", 1, 20, 64, 256),
    ("walker_targets", 1, 23, 64, 256),
    ("walker_burnin_fused", 2, 20, 64, 256),
    ("td3_burnin_fused", 4, 20, 64, 256),
    ("cheetah_unroll", 1, 20, 32, 256),
    ("cheetah_targets", 1, 25, 32, 256),
    ("cheetah_burnin_fused", 2, 20, 32, 256),
    ("humanoid_window", 1, 85, 64, 256),
    ("pendulum_r2d2_burnin_fused", 2, 10, 64, 128),
    ("pendulum_r2d2_targets", 1, 25, 64, 128),
    ("pendulum_tiny_burnin_fused", 2, 2, 8, 32),
    ("pendulum_tiny_targets", 1, 6, 8, 32),
    ("ragged_batch", 1, 5, 33, 256),
    ("one_row", 1, 3, 1, 128),
    ("widest_batch", 4, 4, 256, 256),
    ("batch_1024", 1, 12, 1024, 256),
    ("batch_4096_fused", 2, 4, 4096, 128),
)


# The kernel's outputs against the plain version's on a card: the largest
# gap over the plain output's largest magnitude, and how much further from
# the float64 recurrence than the plain float32 version each may stand.
LSTM_SEQ_GAP = 2e-5
LSTM_SEQ_F64 = 4.0


def lstm_seq_case(e: int, t: int, b: int, h: int, seed: int):
    """numpy inputs of the recurrence and its backward: ``zx [E, T, B, 4H]``,
    ``wh [E, 4H, H]`` (scaled by 1/sqrt(H), as an orthogonal init is),
    ``bh [E, 4H]``, ``c0, h0 [E, B, H]``, ``reset [T, B]`` (row 0 resets at
    step 0 and mid-window, row 1 at every step, the others at random),
    ``dy [E, T, B, H]`` and ``dc_last [E, B, H]``."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    reset = rng.random((t, b)) < 0.1
    reset[[0, t // 2], 0] = True
    if b > 1:
        reset[:, 1] = True
    return {"zx": f(e, t, b, 4 * h), "wh": f(e, 4 * h, h, s=h ** -0.5),
            "bh": f(e, 4 * h, s=0.1), "c0": f(e, b, h, s=0.5), "h0": f(e, b, h, s=0.5),
            "reset": reset, "dy": f(e, t, b, h), "dc_last": f(e, b, h)}


def lstm_seq_errors(e: int, t: int, b: int, h: int, seed: int, device) -> dict:
    """The kernel against its plain version on ``device`` (a card), forward
    and backward with and without the carry's gradient: for each output
    the largest gap over the plain output's largest magnitude
    (``<name>_gap``), and the same for the kernel and the plain version each
    against the plain version in float64 on the CPU (``<name>_f64_kernel``,
    ``<name>_f64_plain``): the kernel's rounding beside float32's own.  The
    backward runs on the plain forward's saved gates and ``c``."""
    import torch

    from r2d2dpg_torch.ops.lstm_seq import (
        lstm_seq_backward_plain,
        lstm_seq_bwd,
        lstm_seq_forward_plain,
        lstm_seq_fwd,
    )

    case = lstm_seq_case(e, t, b, h, seed)
    on = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    f64 = {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
           for k, v in case.items()}
    fwd = ("zx", "wh", "bh", "c0", "h0", "reset")
    names = ("y", "c_last", "gates", "cs")
    kernel = dict(zip(names, lstm_seq_fwd(*(on[k] for k in fwd), True)))
    plain = dict(zip(names, lstm_seq_forward_plain(*(on[k] for k in fwd))))
    exact = dict(zip(names, lstm_seq_forward_plain(*(f64[k] for k in fwd))))
    for carry_grad in (False, True):
        tail = "_carry" if carry_grad else ""
        args = (on["dy"], on["dc_last"], on["wh"], plain["gates"], plain["cs"], on["c0"],
                on["reset"], carry_grad)
        grads = ("dz", "dc0", "dh0") if carry_grad else ("dz",)
        kernel.update({g + tail: x for g, x in zip(grads, lstm_seq_bwd(*args))})
        plain.update({g + tail: x for g, x in zip(grads, lstm_seq_backward_plain(*args))})
        args64 = (f64["dy"], f64["dc_last"], f64["wh"], exact["gates"], exact["cs"],
                  f64["c0"], f64["reset"], carry_grad)
        exact.update({g + tail: x for g, x in zip(grads, lstm_seq_backward_plain(*args64))})
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    out = {}
    for k, want in plain.items():
        scale = float(want.abs().max()) or 1.0
        ref = exact[k]
        out[f"{k}_gap"] = float((kernel[k] - want).abs().max()) / scale
        out[f"{k}_f64_kernel"] = float((kernel[k].cpu().double() - ref).abs().max()) / scale
        out[f"{k}_f64_plain"] = float((want.cpu().double() - ref).abs().max()) / scale
    return out


def lstm_seq_faults(errs: dict) -> list:
    """The outputs of ``lstm_seq_errors``'s result that miss ``LSTM_SEQ_GAP``
    or stand further from float64 than ``LSTM_SEQ_F64`` times the plain
    version's gap (with 1e-7 of room for a gap of nought)."""
    names = [k[: -len("_gap")] for k in errs if k.endswith("_gap")]
    return [k for k in names if errs[f"{k}_gap"] > LSTM_SEQ_GAP
            or errs[f"{k}_f64_kernel"] > LSTM_SEQ_F64 * errs[f"{k}_f64_plain"] + 1e-7]


def lstm_seq_graph_replays(device, seeds=(1, 2), shape=(2, 20, 64, 256)) -> list:
    """The forward and both backwards captured in one CUDA graph and
    replayed on the inputs of each of ``seeds`` copied into the captured
    buffers: for each seed, whether every output equals eager launches on
    those inputs bitwise.  Raises if the capture launched other than 3
    kernels."""
    import torch

    from r2d2dpg_torch.kernels import LSTM_SEQ
    from r2d2dpg_torch.ops.lstm_seq import lstm_seq_bwd, lstm_seq_fwd

    def case(seed):
        return {k: torch.from_numpy(v).to(device)
                for k, v in lstm_seq_case(*shape, seed).items()}

    def body(x):
        y, c_last, gates, cs = lstm_seq_fwd(x["zx"], x["wh"], x["bh"], x["c0"], x["h0"],
                                            x["reset"], True)
        grads = lstm_seq_bwd(x["dy"], x["dc_last"], x["wh"], gates, cs, x["c0"],
                             x["reset"], True)
        dz_only = lstm_seq_bwd(x["dy"], x["dc_last"], x["wh"], gates, cs, x["c0"],
                               x["reset"], False)[0]
        return (y, c_last, gates, cs, *grads, dz_only)

    static = case(0)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body(static)  # warm-up, as a capture asks
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = LSTM_SEQ.launches
    with torch.cuda.graph(graph):
        out = body(static)
    if LSTM_SEQ.launches != before + 3:
        raise AssertionError(f"capture launched {LSTM_SEQ.launches - before} kernels, not 3")
    same = []
    for seed in seeds:
        fresh = case(seed)
        for k, v in fresh.items():
            static[k].copy_(v)
        graph.replay()
        want = body(fresh)
        torch.cuda.synchronize(device)
        same.append(all(torch.equal(g, w) for g, w in zip(out, want, strict=True)))
    return same


class HostStandInEnv:
    """A host-stepped env with ``DMCHostEnv``'s interface and walker-walk's
    spec (obs 24, act 6, bounds +-1, 500-step episodes), for running the
    host-pool trainer where there is no MuJoCo.

    Its step runs on the host in numpy: ``obs' = tanh(obs @ A + act @ B)``
    and ``reward = (1 + tanh(obs' @ w)) / 2 - 0.1 * mean(act**2)``, with
    ``A``, ``B`` and ``w`` fixed by ``seed``, so a wrong action or a wrong
    lane changes the data.  An episode ends after ``episode_length`` steps
    (a truncation: discount stays 1) and that env restarts from a start
    state drawn from its own generator, seeded by ``reset``'s integer
    draws.  It does no physics: a step costs microseconds, so a run shows
    the device half and the schedules, not physics hidden under learning.
    """

    batched = True

    def __init__(self, seed: int = 0, device=None, obs_dim: int = 24,
                 action_dim: int = 6, episode_length: int = 500):
        from r2d2dpg_torch.device import resolve_device
        from r2d2dpg_torch.envs.core import EnvSpec, HostUpload

        rng = np.random.default_rng(seed)
        self.a = (rng.standard_normal((obs_dim, obs_dim)) / np.sqrt(obs_dim)).astype(np.float32)
        self.b = (rng.standard_normal((action_dim, obs_dim)) / np.sqrt(action_dim)).astype(np.float32)
        self.w = (rng.standard_normal(obs_dim) / np.sqrt(obs_dim)).astype(np.float32)
        self.device = resolve_device(device)
        self.spec = EnvSpec(
            name="stand-in-walker-walk", obs_shape=(obs_dim,), action_dim=action_dim,
            action_min=-1.0, action_max=1.0, episode_length=episode_length,
        )
        self.role = "train"
        self._upload = HostUpload(self.device)
        self._obs = self._t = None
        self._rngs: list = []

    def set_role(self, role: str) -> None:
        self.role = role

    def _start(self, i: int) -> np.ndarray:
        return self._rngs[i].uniform(-1.0, 1.0, self.spec.obs_shape).astype(np.float32)

    def reset(self, num_envs: int, draws):
        import torch

        from r2d2dpg_torch.envs.dmc_host import SEED_HIGH, DMCState

        seeds = draws.randint((num_envs,), 0, SEED_HIGH).cpu().numpy()
        self._rngs = [np.random.default_rng(int(s)) for s in seeds]
        self._obs = np.stack([self._start(i) for i in range(num_envs)])
        self._t = np.zeros(num_envs, np.int64)
        ones = np.ones(num_envs, np.float32)
        ts = self._upload.upload(self._obs.copy(), np.zeros(num_envs, np.float32),
                                 ones, ones.copy())
        return DMCState(token=torch.zeros((), dtype=torch.int32, device=self.device)), ts

    def host_step(self, actions: np.ndarray):
        act = np.clip(np.asarray(actions, np.float32), -1.0, 1.0)
        nxt = np.tanh(self._obs @ self.a + act @ self.b).astype(np.float32)
        reward = ((1.0 + np.tanh(nxt @ self.w)) * 0.5
                  - 0.1 * (act * act).mean(axis=1)).astype(np.float32)
        self._t += 1
        done = self._t >= self.spec.episode_length
        for i in np.nonzero(done)[0]:
            nxt[i] = self._start(i)
            self._t[i] = 0
        self._obs = nxt
        return (nxt.copy(), reward, np.ones_like(reward), done.astype(np.float32))

    def step(self, state, action, draws):
        from r2d2dpg_torch.envs.dmc_host import fetch_actions

        del draws
        return state, self._upload.upload(*self.host_step(fetch_actions(action)))


def stand_in_factory(seed: int = 0):
    """An ``ExperimentConfig.env_factory`` (``(device) -> env``) of the stand-in."""
    return lambda device: HostStandInEnv(seed, device)


# Every ``torch.distributed`` collective the port calls (``parallel/mesh.py``,
# ``obs/registry.py``).
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "gather", "barrier")


@contextlib.contextmanager
def count_collectives():
    """While the block runs, count the collectives by the calling thread's
    name: yields a ``Counter`` of ``{thread name: calls}``."""
    import torch.distributed as dist

    counts: collections.Counter = collections.Counter()
    lock = threading.Lock()
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def counting(fn):
        def call(*args, **kwargs):
            with lock:
                counts[threading.current_thread().name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counting(fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
