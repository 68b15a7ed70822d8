"""Actor (deterministic policy) and critic (Q) nets with a carried LSTM state.

Port of ``r2d2dpg_tpu/models/actor_critic.py``:

- ``ActorNet``: obs -> torso -> core -> head -> tanh action.
- ``CriticNet``: (obs, action) -> scalar Q; the action joins after the torso
  (``mix`` on ``concat[x, action]``), then core and head.
- The recurrent state ``(c, h)`` is carried by the caller and zeroed where
  ``reset`` is set before the cell runs.  Feedforward nets
  (``use_lstm=False``) keep the same API with an empty carry ``()``.
- The sequence form (``apply_seq``, ``forward(..., sequence=True)``) runs a
  net over a whole ``[T, B, ...]`` window, which the learner's unrolls run:
  every layer but the recurrence once over the window's ``T*B`` rows, the
  recurrence in one call (``core.sequence``).  The float32 LSTM's is
  ``ops/lstm_seq.py`` (one CUDA kernel each way on a card); the dense core
  has one trivially; ``MixedPrecisionLSTMCell`` has none (the learner
  unrolls it step by step).  Outputs come time-major, ``[T, *E, B, ...]``,
  as ``unroll`` stacks the steps.
- ``core="granite_hybrid"`` puts the Granite-4.0-H hybrid stack
  (``models/granite.py``) in the LSTM's place: its carry is a tuple tree,
  one subtree per layer, and it has a sequence form of its own, which
  takes no ensemble axis.  A carry leaf has the batch axis first, after an
  optional ensemble axis.

The LSTM cell equals flax's ``OptimizedLSTMCell`` in float32: gate order
i, f, g, o; input kernels without bias, recurrent kernels with bias; no
forget-gate offset; lecun-normal input kernels and orthogonal recurrent
kernels.  The four gates' kernels are kept fused (``wi [4H, in]``,
``wh [4H, H]``, ``bh [4H]``), as the flax cell fuses them at apply time.

``dtype`` (``torch.float32`` or ``torch.bfloat16``) is the nets' compute
type, as in JAX.  Params stay float32 under both.  Under bf16 every Dense
(torso, ``mix``, the feedforward core, head) and the convolutions compute
in bf16, the LSTM core is ``MixedPrecisionLSTMCell`` (bf16 operands, float32
products, sums, gate math and carry), and the actor's action and the
critic's Q come back as float32.  ``float32`` keeps ``LSTMCell`` and every
layer exactly as before.  ``pixels`` swaps the MLP torso for ``ConvTorso``
over ``[B, H, W, C]`` frames.

Parameters are ordinary ``nn.Module`` parameters; the learner runs the nets
on explicit parameter dicts through ``torch.func.functional_call``
(``apply_params``), the counterpart of flax's ``module.apply(params, ...)``.  A dict
whose tensors carry a leading ensemble axis runs that many nets at once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from r2d2dpg_torch.device import resolve_device
from r2d2dpg_torch.ops.lstm_seq import lstm_sequence
from r2d2dpg_torch.models.torsos import (
    ConvTorso,
    Dense,
    MLPTorso,
    dense,
    fan_in_uniform,
    lecun_normal,
    orthogonal,
    symmetric_uniform,
)

# () for feedforward nets, (c, h) for LSTM, a tuple tree for granite_hybrid.
Carry = Any
Params = Dict[str, torch.Tensor]
CORES = ("lstm", "granite_hybrid")


def lstm_initial_carry(
    batch_size: int, hidden: int, use_lstm: bool, device=None
) -> Carry:
    """Fresh carry: zeros ``(c, h)`` for LSTM (two distinct buffers), ``()`` else."""
    if not use_lstm:
        return ()
    return (
        torch.zeros(batch_size, hidden, device=device),
        torch.zeros(batch_size, hidden, device=device),
    )


def zeros_where_reset(carry: Carry, reset: torch.Tensor, row_ranks: Any = 1) -> Carry:
    """Zero the recurrent state for batch rows where ``reset`` is truthy.

    A carry leaf is ``[..., B, *row]`` (a leading ensemble axis is allowed);
    ``row_ranks`` gives ``len(row)``: one int for a leaf or a flat tuple of
    leaves (the LSTM's ``(c, h)`` of ``[..., B, H]``: 1), or a tuple of such
    for a tuple of sub-carries.  The ``[B]`` mask is aligned on the batch
    axis from the right; an integer leaf (a position) is zeroed too.
    """
    if isinstance(row_ranks, tuple):
        return tuple(zeros_where_reset(c, reset, r) for c, r in zip(carry, row_ranks, strict=True))
    if not isinstance(carry, torch.Tensor) and not carry:
        return carry
    mask = reset.bool().view(reset.shape + (1,) * row_ranks)
    if isinstance(carry, torch.Tensor):
        return torch.where(mask, 0.0, carry) if carry.is_floating_point() else carry.masked_fill(mask, 0)
    return tuple(torch.where(mask, 0.0, x) for x in carry)


def require_lstm_core(net: nn.Module, where: str) -> None:
    """Refuse, with a ``ValueError`` naming it, a core that ``where`` cannot
    run: its flat ``[B, H]`` carry slabs, stored carries or ensembles
    assume the LSTM's (or the dense core's) carry."""
    core = getattr(net, "core_name", "lstm")
    if core != "lstm":
        raise ValueError(f"{where} cannot run core {core!r}: it handles the "
                         "LSTM's flat [B, H] carry only")


def _gates(z: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's LSTM gate math on fused pre-activations ``z`` (gates i, f, g, o)."""
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


class LSTMCell(nn.Module):
    """float32 LSTM cell, numerically flax's ``OptimizedLSTMCell``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.wi = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.wh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bh = nn.Parameter(torch.zeros(4 * hidden))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        h = self.hidden
        with torch.no_grad():
            for g in range(4):  # per-gate inits, as flax declares them
                lecun_normal()(self.wi[g * h : (g + 1) * h], generator)
                orthogonal()(self.wh[g * h : (g + 1) * h], generator)
            self.bh.zero_()

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        # Same association as flax: (h @ Wh + bh) + x @ Wi.
        c, h = _gates(dense(h, self.wh, self.bh) + dense(x, self.wi, None), c)
        return (c, h), h


def _mixed_matmul(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype):
    """``x @ w.T`` on operands rounded to ``dtype``, multiplied and summed in float32.

    The counterpart of ``jnp.matmul(..., preferred_element_type=float32)`` on
    bf16 operands.  A bf16 ``matmul`` would round its RESULT to bf16; here
    both operands are rounded and then upcast, and a product of two bf16
    values is exact in float32, so only the float32 sum's order differs.
    """
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float().transpose(-1, -2))


class MixedPrecisionLSTMCell(LSTMCell):
    """LSTM cell with ``dtype`` gate-matmul operands and FLOAT32 state arithmetic.

    Port of the JAX package's ``MixedPrecisionLSTMCell``: the two gate
    projections take ``dtype`` operands with float32 accumulation and
    result; the bias join, the gate math, ``c``, ``h`` and the carry stay
    float32; the output ``y`` is ``h`` cast to ``dtype``.  The parameters
    (and their init) are ``LSTMCell``'s, so float32 and bf16 params
    interchange.
    """

    def __init__(self, in_features: int, hidden: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, hidden)
        self.dtype = dtype

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        c, h = carry  # float32 by contract (lstm_initial_carry)
        zx = _mixed_matmul(x, self.wi, self.dtype)
        zh = _mixed_matmul(h, self.wh, self.dtype)
        # Same association as JAX: (zx + zh) + bh.
        c, h = _gates(zx + zh + self.bh.unsqueeze(-2), c)
        return (c, h), h.to(self.dtype)


class _Core(nn.Module):
    """Shared recurrent-or-dense core: LSTM cell when ``use_lstm`` else Dense+ReLU.

    Under a reduced ``dtype`` the cell is ``MixedPrecisionLSTMCell``; it sits
    at the same path (``core.cell``) with the same params as ``LSTMCell``.
    Params may carry a leading ensemble axis (fused burn-in, twin critics).
    """

    ensemble_axis = True  # every form, step and sequence

    def __init__(
        self,
        in_features: int,
        hidden: int,
        use_lstm: bool,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.hidden, self.use_lstm = hidden, use_lstm
        if use_lstm and dtype == torch.float32:
            self.cell = LSTMCell(in_features, hidden)
        elif use_lstm:
            self.cell = MixedPrecisionLSTMCell(in_features, hidden, dtype)
        else:
            self.dense = Dense(in_features, hidden, fan_in_uniform(), dtype)

    def forward(self, x: torch.Tensor, carry: Carry, reset: torch.Tensor):
        if self.use_lstm:
            carry, y = self.cell(zeros_where_reset(carry, reset), x)
            return y, carry
        return torch.relu(self.dense(x)), carry

    @property
    def unroll_route(self) -> Tuple[str, str]:
        """``(form, reason)`` of the learner's unrolls: ``"sequence"`` for the
        float32 LSTM and the dense core, ``"step"`` for the mixed-precision
        cell, which has no sequence form."""
        if not self.use_lstm:
            return "sequence", "dense"
        if isinstance(self.cell, MixedPrecisionLSTMCell):
            return "step", "mixed_precision"
        return "sequence", "float32"

    @property
    def sequence_form(self) -> bool:
        """The learner's unrolls run ``sequence``: by ``unroll_route``."""
        return self.unroll_route[0] == "sequence"

    def sequence(self, x: torch.Tensor, carry: Carry, reset: torch.Tensor):
        """The window at once: ``x [*E, T, B, in]``, ``reset [T, B]`` ->
        ``(y [*E, T, B, H], carry after the last step)``."""
        if not self.use_lstm:
            return torch.relu(self.dense(x.flatten(-3, -2))).unflatten(-2, reset.shape), carry
        zx = dense(x.flatten(-3, -2), self.cell.wi, None).unflatten(-2, reset.shape)
        return lstm_sequence(zx, self.cell.wh, self.cell.bh, carry, reset)

    def initial_carry(self, batch_size: int, device=None) -> Carry:
        return lstm_initial_carry(batch_size, self.hidden, self.use_lstm, device)


def make_core(core: str, hidden: int, use_lstm: bool, dtype: torch.dtype,
              granite=None, context: int = 1) -> nn.Module:
    """``_Core`` (LSTM or dense, by ``use_lstm``) for ``"lstm"``; the hybrid
    stack of ``granite`` (a ``GraniteSpec``, the published widths when
    None) for ``"granite_hybrid"``, float32 only."""
    if core == "lstm":
        return _Core(hidden, hidden, use_lstm, dtype)
    if core != "granite_hybrid":
        raise ValueError(f"unknown core {core!r}; have {CORES}")
    from r2d2dpg_torch.models.granite import GRANITE_4_0_H_MICRO, GraniteHybridCore

    if dtype != torch.float32:
        raise ValueError("core 'granite_hybrid' computes in float32 only")
    return GraniteHybridCore(hidden, granite or GRANITE_4_0_H_MICRO, context)


class _Net(nn.Module):
    """What the actor and critic share: init into a params dict, and apply."""

    hidden: int
    use_lstm: bool
    core_name: str = "lstm"

    @property
    def stateful(self) -> bool:
        """The core carries state (burn-in has something to warm)."""
        return self.use_lstm or self.core_name != "lstm"

    @property
    def sequence_form(self) -> bool:
        """The core has a sequence form (``apply_seq``) besides its step."""
        return self.core.sequence_form

    @property
    def ensemble_axis(self) -> bool:
        """The core takes params stacked on a leading ensemble axis."""
        return self.core.ensemble_axis

    def init_params(
        self, generator: Optional[torch.Generator] = None, device=None
    ) -> Params:
        """Re-initialize from ``generator``; a detached params dict on ``device``.

        Initialization runs where the module lives (the CPU by default) so one
        seed gives the same params on every device; ``device`` defaults to
        ``cuda`` like every entry point of the port.
        """
        device = resolve_device(device)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return {k: v.detach().clone().to(device) for k, v in self.named_parameters()}

    def apply_params(self, params: Params, *args):
        """Run the net on ``params`` (flax's ``module.apply(params, ...)``)."""
        return functional_call(self, params, args)

    def apply_seq(self, params: Params, *args):
        """The sequence form on ``params``: the step's arguments with a
        leading time axis, ``-> (outputs [T, B, ...], carry after the last step)``."""
        return functional_call(self, params, args, {"sequence": True})

    def initial_carry(self, batch_size: int, device=None) -> Carry:
        return self.core.initial_carry(batch_size, device)

    def _core(self, x, carry, reset, sequence: bool):
        """The core on ``x [*E, rows, H]``: one step's rows, or with
        ``sequence`` the window's ``T*B`` (time-major) -> ``(y [*E, rows, H],
        carry)``."""
        if not sequence:
            return self.core(x, carry, reset)
        y, carry = self.core.sequence(x.unflatten(-2, reset.shape), carry, reset)
        return y.flatten(-3, -2), carry


def _rows(x: torch.Tensor, sequence: bool) -> torch.Tensor:
    """A window's time-major ``[T, B, ...]`` as ``[T*B, ...]`` rows."""
    return x.flatten(0, 1) if sequence else x


def _steps(y: torch.Tensor, reset: torch.Tensor, sequence: bool) -> torch.Tensor:
    """``[*E, T*B, F]`` back to time-major ``[T, *E, B, F]`` (as ``unroll``
    stacks the steps)."""
    return y.unflatten(-2, reset.shape).movedim(-3, 0) if sequence else y


ObsShape = Union[int, Sequence[int]]


def _make_torso(
    obs_shape: ObsShape, pixels: bool, hidden: int, dtype: torch.dtype
) -> nn.Module:
    """``ConvTorso`` over ``(H, W, C)`` frames, else an MLP over ``obs_dim``."""
    if pixels:
        return ConvTorso(obs_shape, out_size=hidden, dtype=dtype)
    (obs_dim,) = (obs_shape,) if isinstance(obs_shape, int) else obs_shape
    return MLPTorso(obs_dim, (hidden,), dtype)


class ActorNet(_Net):
    """Deterministic policy mu(obs) with optional LSTM core.

    ``obs_shape`` is the flat obs size (an int or ``(obs_dim,)``), or
    ``(H, W, C)`` with ``pixels``.
    """

    def __init__(
        self,
        obs_shape: ObsShape,
        action_dim: int,
        hidden: int = 256,
        use_lstm: bool = True,
        pixels: bool = False,
        action_scale: float = 1.0,
        dtype: torch.dtype = torch.float32,
        core: str = "lstm",
        granite=None,
        context: int = 1,
    ):
        super().__init__()
        self.hidden, self.use_lstm, self.core_name = hidden, use_lstm, core
        self.action_scale = action_scale
        self.torso = _make_torso(obs_shape, pixels, hidden, dtype)
        self.core = make_core(core, hidden, use_lstm, dtype, granite, context)
        self.head = Dense(hidden, action_dim, symmetric_uniform(3e-3), dtype)

    def forward(
        self, obs: torch.Tensor, carry: Carry, reset: torch.Tensor,
        sequence: bool = False,
    ) -> Tuple[torch.Tensor, Carry]:
        """Single step: obs [B, ...], reset [B] -> (action [B, A], new carry);
        with ``sequence``, obs [T, B, ...] and reset [T, B] -> action
        [T, *E, B, A]."""
        y, carry = self._core(self.torso(_rows(obs, sequence)), carry, reset, sequence)
        action = _steps(torch.tanh(self.head(y)).to(torch.float32), reset, sequence)
        return action * self.action_scale, carry


class CriticNet(_Net):
    """Q(obs, action) with optional LSTM core; action joined after the torso."""

    def __init__(
        self,
        obs_shape: ObsShape,
        action_dim: int,
        hidden: int = 256,
        use_lstm: bool = True,
        pixels: bool = False,
        dtype: torch.dtype = torch.float32,
        core: str = "lstm",
        granite=None,
        context: int = 1,
    ):
        super().__init__()
        self.hidden, self.use_lstm, self.core_name = hidden, use_lstm, core
        self.torso = _make_torso(obs_shape, pixels, hidden, dtype)
        self.mix = Dense(hidden + action_dim, hidden, fan_in_uniform(), dtype)
        self.core = make_core(core, hidden, use_lstm, dtype, granite, context)
        self.head = Dense(hidden, 1, symmetric_uniform(3e-3), dtype)

    def forward(
        self,
        obs: torch.Tensor,
        action: torch.Tensor,
        carry: Carry,
        reset: torch.Tensor,
        sequence: bool = False,
    ) -> Tuple[torch.Tensor, Carry]:
        """Single step -> (q [B], new carry); with ``sequence``, every input
        with a leading time axis (the action's after an optional ensemble
        axis) -> (q [T, *E, B], carry)."""
        x = self.torso(_rows(obs, sequence))
        if sequence:  # [T, *E, B, A] -> [*E, T*B, A]
            action = action.movedim(0, -3).flatten(-3, -2)
        action = action.to(x.dtype).expand(*x.shape[:-1], action.shape[-1])
        x = torch.relu(self.mix(torch.cat([x, action], dim=-1)))
        y, carry = self._core(x, carry, reset, sequence)
        q = _steps(self.head(y).to(torch.float32), reset, sequence)
        return q.squeeze(-1), carry


def policy_step_fn(actor: ActorNet) -> Callable[..., Tuple[torch.Tensor, Carry]]:
    """Single-step policy function for serving callers.

    Returns ``step(params, obs, carry, reset) -> (action, new_carry)``:
    ``actor.apply_params`` without autograd, in the argument order the
    serving batcher threads through its session slabs.  It closes over the
    module only, so one function serves every hot-reloaded param version.
    """

    @torch.no_grad()
    def step(params: Params, obs: torch.Tensor, carry: Carry, reset: torch.Tensor):
        return actor.apply_params(params, obs, carry, reset)

    return step


def unroll(
    apply_step: Callable[..., Tuple[Any, Carry]],
    carry: Carry,
    *step_inputs: torch.Tensor,
) -> Tuple[Any, Carry]:
    """Unroll a single-step net over the leading (time) axis.

    ``apply_step(carry, *inputs_t) -> (out_t, carry)``; ``out_t`` is a tensor
    or a tuple of tensors.  Returns ``(outputs [T, ...], final_carry)`` with
    tuple outputs stacked element-wise.
    """
    outs = []
    for t in range(step_inputs[0].shape[0]):
        out, carry = apply_step(carry, *(x[t] for x in step_inputs))
        outs.append(out)
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs)), carry
    return torch.stack(outs), carry


def time_major(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [T, B, ...] (replay is batch-major; unrolls are time-major)."""
    return x.transpose(0, 1)
