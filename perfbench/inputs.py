"""Inputs the benchmark makes from ``--seed``, the same for both sides.

Everything is drawn on the run's device from ``torch.Generator``s seeded
by ``subseed(seed, name)``, one independent stream per kind of input, in
a few large calls: the nets' weights (one draw for every leaf), a full
replay arena (one draw per leaf), and the learner's and collectors'
uniforms and normals (``Draws``).  Calling a maker again with the same
seed on the same device gives the same numbers, which is how the plain
reference gets its copy after the program's state is freed.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence

import torch


def subseed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(subseed(seed, name))
    return g


def _scale(key: str, shape: Sequence[int]) -> float:
    """Half-width of a leaf's uniform draw: ``1/sqrt(fan_in)`` for a kernel,
    3e-3 for an output head (as DDPG initializes it), 0.05 for a bias."""
    if len(shape) == 1:
        return 0.05
    if key == "head.weight":
        return 3e-3
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def make_weights(shapes: Dict[str, Dict[str, tuple]], seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{net: {key: tensor}}`` in float32, uniform in ``+-_scale``, from one
    draw of every leaf's numbers on ``device``."""
    leaves = [(net, k, tuple(s)) for net in sorted(shapes) for k, s in shapes[net].items()]
    total = sum(math.prod(s) for _, _, s in leaves)
    flat = torch.rand(total, generator=generator(seed, "weights", device), device=device)
    flat = flat * 2 - 1
    out: Dict[str, Dict[str, torch.Tensor]] = {net: {} for net in shapes}
    off = 0
    for net, k, s in leaves:
        n = math.prod(s)
        out[net][k] = (flat[off:off + n] * _scale(k, s)).reshape(s).clone()
        off += n
    return out


def alloc_arena(capacity: int, seq_len: int, obs_shape, obs_dtype: str, action_dim: int,
                carries: Dict[str, List], device) -> Dict:
    """Zeroed arena leaves in the layout ``fill_arena`` writes; ``carries`` is
    the model entry's ``{net: [(draw, per-row shape), ...]}``."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "obs": z(capacity, seq_len, *obs_shape, dtype=getattr(torch, obs_dtype)),
        "action": z(capacity, seq_len, action_dim),
        "reward": z(capacity, seq_len),
        "discount": z(capacity, seq_len),
        "reset": z(capacity, seq_len),
        "carry_actor": tuple(z(capacity, *shape) for _, shape in carries["actor"]),
        "carry_critic": tuple(z(capacity, *shape) for _, shape in carries["critic"]),
    }


# The draws a stored carry leaf can take, by the name a model entry gives.
CARRY_DRAWS = {
    "normal": lambda x, g: x.normal_(0.0, 0.5, generator=g),
    "uniform": lambda x, g: x.uniform_(-0.5, 0.5, generator=g),
}


def fill_arena(arena: Dict, priority: torch.Tensor, seed: int, episode_length: int,
               priority_range: Sequence[float], carries: Dict[str, List]) -> None:
    """Fill a full arena in place: observations N(0, 1) (uint8 frames
    uniform over 0..255), actions U(-1, 1), rewards N(0, 1), discounts 1;
    the share ``seq_len / episode_length`` of the sequences, those that
    cross an episode boundary, get one reset at a uniform position; each
    stored carry leaf the draw that ``carries`` names for it (``CARRY_DRAWS``:
    ``N(0, 0.25)`` or ``U(-0.5, 0.5)``), the actor's leaves first;
    priorities uniform in ``priority_range``."""
    g = generator(seed, "arena", priority.device)
    obs = arena["obs"]
    if obs.dtype == torch.uint8:
        obs.random_(0, 256, generator=g)
    else:
        obs.normal_(generator=g)
    arena["action"].uniform_(-1.0, 1.0, generator=g)
    arena["reward"].normal_(generator=g)
    arena["discount"].fill_(1.0)
    reset = arena["reset"]
    cap, seq_len = reset.shape
    reset.zero_()
    crosses = torch.rand(cap, generator=g, device=reset.device) < seq_len / episode_length
    pos = torch.randint(0, seq_len, (cap,), generator=g, device=reset.device)
    reset[torch.arange(cap, device=reset.device), pos] = crosses.float()
    for net in ("actor", "critic"):
        for (draw, _), leaf in zip(carries[net], arena[f"carry_{net}"], strict=True):
            CARRY_DRAWS[draw](leaf, g)
    priority.uniform_(*priority_range, generator=g)


class Draws:
    """The uniforms and normals a loop asks for, from the benchmark's own
    generator on ``device``; the reference draws its copy from a second
    ``Draws`` of the same seed and name."""

    def __init__(self, seed: int, name: str, device):
        self.device = torch.device(device)
        self.generator = generator(seed, name, device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def uniform(self, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return u * (high - low) + low

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.device)

    def fold(self, rank: int) -> "Draws":
        if rank != 0:
            raise ValueError("the benchmark's draws serve a world of one")
        return self


def pop(log: List[torch.Tensor], shape) -> torch.Tensor:
    """The next draw of a list made in order, which must have ``shape``."""
    x = log.pop(0)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"draw {tuple(x.shape)} where {tuple(shape)} was asked")
    return x
