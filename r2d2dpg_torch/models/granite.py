"""Granite-4.0-H hybrid core: Mamba-2 and GQA layers, each with a gated MLP.

The core of granite-4.0-h-micro (``granitemoehybrid``; IBM's published
``config.json``), as a recurrent core of the actor and critic in place of
the LSTM.  Per decoder layer, with ``r`` the residual multiplier:

    h = x + r * mixer(RMSNorm(x))
    h = h + r * MLP(RMSNorm(h)),   MLP(u) = W_out (silu(a) * b), [a, b] = W_in u

The mixer is a Mamba-2 layer (one group) or causal GQA attention without
positional encoding (NoPE) and with the scale ``attention_multiplier`` in
place of ``1/sqrt(head_dim)``.  The core's input is multiplied by
``embedding_multiplier`` and a final RMSNorm follows the stack.  There is
no language-model head, so ``logits_scaling`` has no place here: the
actor's and critic's heads take the output.

Mamba-2 (``in_proj`` splits into the gate ``z``, ``xBC`` and ``dt``):
``xBC`` runs through a causal depthwise convolution (kernel
``mamba_d_conv``, with bias) and ``silu`` and splits into ``x`` (heads of
``mamba_d_head``), ``B`` and ``C`` (``mamba_d_state`` each); ``dt =
softplus(dt + dt_bias)``, ``A = -exp(A_log)``; per head, with state ``S
[d_head, d_state]``, ``S <- exp(dt A) S + dt x B^T`` and ``y = S C + D x``;
then ``RMSNorm(y * silu(z))`` with a weight and ``out_proj``.

Two forms compute the same thing:

- the **step form** (``forward``: ``x [B, d]``) carries the state and is
  what acting runs.  A row's state is zeroed where ``reset`` is set, before
  the step.  Per layer the carry is ``(window [B, d_conv - 1, conv_dim],
  ssm [B, heads, d_head, d_state])`` for Mamba-2 and ``(keys [B, C, kv,
  head_dim], values [B, C, kv, head_dim], pos [B])`` for attention: the
  keys and values of the episode so far in slots ``0 .. pos - 1`` of a
  buffer of ``context`` slots (the episode length), ``pos`` the row's
  position in its episode.  Positions past ``context`` are not stored.
- the **sequence form** (``sequence``: ``x [T, B, d]``, ``reset [T, B]``)
  is what the learner runs: the state-space-dual form of Mamba-2 over the
  whole sequence (one chunk: a learner's sequence is tens of steps) and
  masked causal attention over the carried buffer and the sequence.  A
  reset inside the sequence cuts every path across it: the SSM decay, the
  convolution's taps and the attention mask go by segment (the number of
  resets up to each step), and the carry enters only the first segment.
  Autograd through it keeps the ``[B, heads, T, T]`` decay matrices and
  not every step's SSM state.

The spans ``core/mamba``, ``core/attention`` and ``core/mlp`` name each
layer's mixer and MLP in both forms (``utils/profiling.annotate``).  The
core computes in float32 and takes no ensemble axis (a learner that
stacks params, ``fused_burnin`` or twin critics, refuses it).

Parameters keep the published module paths (``layers.<i>.mamba.in_proj``
and so on).  The large projections are made by ``reset_parameters``
(``_Net.init_params``), not at construction: at the published widths a
net holds 0.75 B parameters, and the learner runs on params dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r2d2dpg_torch.models.actor_critic import zeros_where_reset
from r2d2dpg_torch.models.torsos import dense
from r2d2dpg_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class GraniteSpec:
    """The core's widths, under the published config's key names."""

    hidden_size: int = 2048
    shared_intermediate_size: int = 8192
    layer_types: Tuple[str, ...] = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_d_conv: int = 4
    mamba_n_groups: int = 1
    mamba_expand: int = 2
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    residual_multiplier: float = 0.22
    attention_multiplier: float = 0.015625
    embedding_multiplier: float = 12.0
    rms_norm_eps: float = 1e-5

    def __post_init__(self):
        if self.mamba_n_groups != 1:
            raise ValueError("granite_hybrid: one Mamba-2 group (mamba_n_groups=1) only")
        if self.mamba_n_heads * self.mamba_d_head != self.mamba_expand * self.hidden_size:
            raise ValueError("granite_hybrid: mamba_n_heads * mamba_d_head must be "
                             "mamba_expand * hidden_size")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("granite_hybrid: query heads must be a multiple of KV heads")
        if set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"granite_hybrid: unknown layer types {self.layer_types}")

    @property
    def num_hidden_layers(self) -> int:
        return len(self.layer_types)

    @property
    def mamba_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.mamba_inner + 2 * self.mamba_d_state

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# granite-4.0-h-micro's first period, layers 0-9, at its published widths.
GRANITE_4_0_H_MICRO = GraniteSpec()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


class _Weight(nn.Module):
    """A bias-free projection's ``weight [out, in]`` (fan-in uniform)."""

    def __init__(self, out_features: int, in_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[-1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        if gate is not None:
            x = x * F.silu(gate)
        return rms_norm(x, self.weight, self.eps)


class _Conv1d(nn.Module):
    """The depthwise convolution's ``weight [channels, 1, kernel]`` and ``bias``."""

    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[-1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """``[..., T, T]``: entry ``(t, s)`` is ``a[s+1] + ... + a[t]`` for
    ``s <= t`` (a sum of its own terms, not a difference of two cumulative
    sums) and ``-inf`` above the diagonal."""
    t = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, t)
    strict = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    s = x.masked_fill(~strict, 0.0).cumsum(-2)
    return s.masked_fill(~torch.ones_like(strict).tril(), -math.inf)


class Mamba2Mixer(nn.Module):
    def __init__(self, spec: GraniteSpec):
        super().__init__()
        self.spec = spec
        s = spec
        self.in_proj = _Weight(s.mamba_inner + s.conv_dim + s.mamba_n_heads, s.hidden_size)
        self.conv1d = _Conv1d(s.conv_dim, s.mamba_d_conv)
        self.dt_bias = nn.Parameter(torch.zeros(s.mamba_n_heads))
        self.A_log = nn.Parameter(torch.zeros(s.mamba_n_heads))
        self.D = nn.Parameter(torch.ones(s.mamba_n_heads))
        self.norm = RMSNorm(s.mamba_inner, s.rms_norm_eps)
        self.out_proj = _Weight(s.hidden_size, s.mamba_inner)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Mamba-2's own inits: ``A`` in [1, 16], ``dt`` log-uniform in
        [1e-3, 0.1] through the inverse softplus, ``D`` one."""
        h = self.spec.mamba_n_heads
        with torch.no_grad():
            a = torch.empty(h).uniform_(1.0, 16.0, generator=generator)
            self.A_log.copy_(torch.log(a))
            u = torch.empty(h).uniform_(0.0, 1.0, generator=generator)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            self.D.fill_(1.0)

    def initial_carry(self, batch_size: int, device=None):
        s = self.spec
        return (torch.zeros(batch_size, s.mamba_d_conv - 1, s.conv_dim, device=device),
                torch.zeros(batch_size, s.mamba_n_heads, s.mamba_d_head, s.mamba_d_state,
                            device=device))

    ROW_RANKS = (2, 3)

    def _project(self, x):
        s = self.spec
        zxbcdt = dense(x, self.in_proj.weight, None)
        return zxbcdt.split([s.mamba_inner, s.conv_dim, s.mamba_n_heads], -1)

    def _heads(self, xbc, dt):
        s = self.spec
        xs, b, c = F.silu(xbc).split([s.mamba_inner, s.mamba_d_state, s.mamba_d_state], -1)
        return (xs.unflatten(-1, (s.mamba_n_heads, s.mamba_d_head)), b, c,
                F.softplus(dt + self.dt_bias), -torch.exp(self.A_log))

    def _out(self, y, z):
        return dense(self.norm(y.flatten(-2), z), self.out_proj.weight, None)

    def forward(self, x, carry, seg=None):
        return self._step(x, carry) if seg is None else self._sequence(x, carry, seg)

    def _step(self, x, carry):
        window, ssm = carry
        z, xbc, dt = self._project(x)
        full = torch.cat([window, xbc.unsqueeze(-2)], -2)  # [B, K, C]
        xbc = (full * self.conv1d.weight[:, 0].t()).sum(-2) + self.conv1d.bias
        xh, b, c, dt, a = self._heads(xbc, dt)  # xh [B, H, P]
        ssm = (ssm * torch.exp(dt * a)[..., None, None]
               + (dt[..., None] * xh)[..., None] * b[..., None, None, :])
        y = torch.matmul(ssm, c[..., None, :, None]).squeeze(-1) + self.D[:, None] * xh
        return self._out(y, z), (full[..., 1:, :], ssm)

    def _sequence(self, x, carry, seg):
        window, ssm0 = carry
        t, k = x.shape[0], self.spec.mamba_d_conv
        z, xbc, dt = self._project(x)
        # Causal depthwise convolution over [window, sequence]; a tap from
        # before a reset is cut.
        u = torch.cat([window.transpose(0, 1), xbc], 0)  # [K-1+T, B, C]
        seg_u = torch.cat([seg.new_zeros(k - 1, seg.shape[1]), seg], 0)
        w = self.conv1d.weight[:, 0]
        acc = None
        for j in range(k):
            tap = torch.where((seg_u[j:j + t] == seg)[..., None], u[j:j + t] * w[:, j], 0.0)
            acc = tap if acc is None else acc + tap
        window = torch.where((seg_u[t:] == seg[-1])[..., None], u[t:], 0.0).transpose(0, 1)
        xh, b, c, dt, a = self._heads(acc + self.conv1d.bias, dt)
        # State-space dual form, [B, H, T, ...].
        la = (dt * a).permute(1, 2, 0)  # [B, H, T] log-decay of each step
        sb = seg.t()
        same = sb[:, :, None] == sb[:, None, :]  # [B, T, T]
        decay = torch.exp(_segsum(la).masked_fill(~same[:, None], -math.inf))
        bb, cb = b.transpose(0, 1), c.transpose(0, 1)  # [B, T, N]
        xdt = (xh * dt[..., None]).permute(1, 2, 0, 3)  # [B, H, T, P]
        y = torch.matmul(decay * torch.matmul(cb, bb.transpose(-1, -2))[:, None], xdt)
        first = (sb == 0)[:, None, :]  # [B, 1, T]: the carried state reaches these
        cs = torch.cumsum(la, -1)
        enter = torch.where(first, torch.exp(cs), 0.0)
        y = y + enter[..., None] * torch.matmul(cb[:, None], ssm0.transpose(-1, -2))
        y = y.permute(2, 0, 1, 3) + self.D[:, None] * xh  # [T, B, H, P]
        ssm = torch.matmul((xdt * decay[:, :, -1, :, None]).transpose(-1, -2), bb[:, None])
        ssm = ssm + enter[..., -1:, None] * ssm0
        return self._out(y, z), (window, ssm)


class GQAttention(nn.Module):
    def __init__(self, spec: GraniteSpec, context: int):
        super().__init__()
        if context < 1:
            raise ValueError("granite_hybrid: attention needs a context of at least 1")
        self.spec, self.context = spec, context
        s, kv = spec, spec.num_key_value_heads * spec.head_dim
        self.q_proj = _Weight(s.hidden_size, s.hidden_size)
        self.k_proj = _Weight(kv, s.hidden_size)
        self.v_proj = _Weight(kv, s.hidden_size)
        self.o_proj = _Weight(s.hidden_size, s.hidden_size)

    ROW_RANKS = (3, 3, 0)

    def initial_carry(self, batch_size: int, device=None):
        s = self.spec
        shape = (batch_size, self.context, s.num_key_value_heads, s.head_dim)
        return (torch.zeros(shape, device=device), torch.zeros(shape, device=device),
                torch.zeros(batch_size, dtype=torch.long, device=device))

    def _qkv(self, x):
        s = self.spec
        kv, g = s.num_key_value_heads, s.num_attention_heads // s.num_key_value_heads
        q = dense(x, self.q_proj.weight, None).unflatten(-1, (kv, g, s.head_dim))
        k = dense(x, self.k_proj.weight, None).unflatten(-1, (kv, s.head_dim))
        v = dense(x, self.v_proj.weight, None).unflatten(-1, (kv, s.head_dim))
        return q, k, v

    def _attend(self, q, keys, values, valid):
        """``q [B, kv, g, Q, hd]`` over ``keys``/``values [B, N, kv, hd]``
        where ``valid [B, Q, N]``; ``[B, kv, g, Q, hd]``."""
        scores = torch.matmul(q, keys.permute(0, 2, 3, 1)[:, :, None])
        scores = (scores * self.spec.attention_multiplier).masked_fill(
            ~valid[:, None, None], -math.inf)
        return torch.matmul(torch.softmax(scores, -1), values.transpose(1, 2)[:, :, None])

    def forward(self, x, carry, seg=None):
        return self._step(x, carry) if seg is None else self._sequence(x, carry, seg)

    def _step(self, x, carry):
        keys, values, pos = carry
        q, k, v = self._qkv(x)
        slots = torch.arange(self.context, device=x.device)
        at = (slots[None] == pos[:, None])[..., None, None]  # [B, C, 1, 1]
        keys = torch.where(at, k[:, None], keys)
        values = torch.where(at, v[:, None], values)
        valid = (slots[None] <= pos[:, None])[:, None]  # [B, 1, C]
        o = self._attend(q[..., None, :], keys, values, valid)
        out = dense(o.flatten(-4), self.o_proj.weight, None)
        return out, (keys, values, pos + 1)

    def _sequence(self, x, carry, seg):
        keys0, values0, pos = carry
        t, n, c = x.shape[0], x.shape[1], self.context
        q, k, v = self._qkv(x)  # [T, B, ...]
        q = q.permute(1, 2, 3, 0, 4)  # [B, kv, g, T, hd]
        k, v = k.transpose(0, 1), v.transpose(0, 1)  # [B, T, kv, hd]
        sb = seg.t()  # [B, T]
        steps = torch.arange(t, device=x.device)
        slots = torch.arange(c, device=x.device)
        old = (slots[None, None] < pos[:, None, None]) & (sb == 0)[:, :, None]
        new = (steps[:, None] >= steps[None, :]) & (sb[:, :, None] == sb[:, None, :])
        o = self._attend(q, torch.cat([keys0, k], 1), torch.cat([values0, v], 1),
                         torch.cat([old, new], -1))
        out = dense(o.permute(3, 0, 1, 2, 4).flatten(-3), self.o_proj.weight, None)
        # The buffer after the sequence: the last segment's keys at their
        # positions in the episode (after the carried ones where no reset
        # came), the rest dropped into a spare slot ``c``.
        reset = sb != torch.cat([sb.new_zeros(n, 1), sb[:, :-1]], 1)
        start = torch.cummax(torch.where(reset, steps, 0), 1).values
        slot = torch.where(sb == 0, pos[:, None] + steps, steps - start)
        slot = torch.where((sb == sb[:, -1:]) & (slot < c), slot, c)
        rows = torch.arange(n, device=x.device)[:, None].expand(n, t)
        kept = (sb[:, -1] == 0)[:, None, None, None]

        def place(buf, new_rows):
            spare = torch.cat([torch.where(kept, buf, 0.0), buf.new_zeros(n, 1, *buf.shape[2:])], 1)
            return spare.index_put((rows, slot), new_rows)[:, :c]

        pos = torch.where(sb[:, -1] == 0, pos + t, t - start[:, -1])
        return out, (place(keys0, k), place(values0, v), pos)


class GatedMLP(nn.Module):
    def __init__(self, spec: GraniteSpec):
        super().__init__()
        self.input_linear = _Weight(2 * spec.shared_intermediate_size, spec.hidden_size)
        self.output_linear = _Weight(spec.hidden_size, spec.shared_intermediate_size)

    def forward(self, x):
        a, b = dense(x, self.input_linear.weight, None).chunk(2, -1)
        return dense(F.silu(a) * b, self.output_linear.weight, None)


class GraniteLayer(nn.Module):
    def __init__(self, spec: GraniteSpec, kind: str, context: int):
        super().__init__()
        self.kind, self.residual = kind, spec.residual_multiplier
        self.input_layernorm = RMSNorm(spec.hidden_size, spec.rms_norm_eps)
        if kind == "mamba":
            self.mamba = Mamba2Mixer(spec)
        else:
            self.self_attn = GQAttention(spec, context)
        self.post_attention_layernorm = RMSNorm(spec.hidden_size, spec.rms_norm_eps)
        self.shared_mlp = GatedMLP(spec)

    @property
    def mixer(self) -> nn.Module:
        return self.mamba if self.kind == "mamba" else self.self_attn

    def forward(self, h, carry, seg=None):
        with annotate(f"core/{self.kind}"):
            m, carry = self.mixer(self.input_layernorm(h), carry, seg)
        h = h + m * self.residual
        with annotate("core/mlp"):
            h = h + self.shared_mlp(self.post_attention_layernorm(h)) * self.residual
        return h, carry


class GraniteHybridCore(nn.Module):
    """The stack: ``x * embedding_multiplier``, the layers, a final RMSNorm.

    ``context`` is the attention buffer's slots in the step form's carry
    (the longest episode the acting path runs)."""

    sequence_form = True  # the learner's unrolls run ``sequence``
    ensemble_axis = False  # no params stacked on a leading ensemble axis

    def __init__(self, in_features: int, spec: GraniteSpec = GRANITE_4_0_H_MICRO,
                 context: int = 1):
        super().__init__()
        if in_features != spec.hidden_size:
            raise ValueError(f"granite_hybrid: input width {in_features} is not "
                             f"hidden_size {spec.hidden_size}")
        self.spec, self.context = spec, context
        self.layers = nn.ModuleList(GraniteLayer(spec, kind, context)
                                    for kind in spec.layer_types)
        self.norm = RMSNorm(spec.hidden_size, spec.rms_norm_eps)

    @property
    def row_ranks(self):
        """Each carry leaf's rank after its batch axis (``zeros_where_reset``)."""
        return tuple(layer.mixer.ROW_RANKS for layer in self.layers)

    def initial_carry(self, batch_size: int, device=None):
        return tuple(layer.mixer.initial_carry(batch_size, device) for layer in self.layers)

    def _stack(self, x, carry, seg):
        h = x * self.spec.embedding_multiplier
        out = []
        for layer, c in zip(self.layers, carry):
            h, c = layer(h, c, seg)
            out.append(c)
        return self.norm(h), tuple(out)

    def forward(self, x, carry, reset):
        """Step form: ``x [B, d]``, ``reset [B]`` -> ``(y [B, d], carry)``."""
        return self._stack(x, zeros_where_reset(carry, reset, self.row_ranks), None)

    def sequence(self, x, carry, reset):
        """Sequence form: ``x [T, B, d]``, ``reset [T, B]`` -> ``(y [T, B, d],
        carry after the last step)``."""
        return self._stack(x, carry, (reset > 0).long().cumsum(0))
