"""LSTM recurrence over a window: the CUDA kernel's wrapper and its plain version.

``lstm_sequence(zx, wh, bh, carry, reset)`` runs flax's ``OptimizedLSTMCell``
over the ``T`` steps of a window, given its input projection ``zx = x Wi^T``
for every step at once, as ``LSTMCell`` runs it step by step: the carry
``(c, h)`` zeroed where ``reset[t]`` before step ``t``, ``z = ((h Wh^T) + bh)
+ zx[t]`` with gates i, f, g, o, ``c = sigmoid(f) c + sigmoid(i) tanh(g)``,
``h = sigmoid(o) tanh(c)``.  Shapes, with an optional leading ensemble axis
``E`` on the parameters, the carry and ``zx``: ``zx [*E, T, B, 4H]``, ``wh
[*E, 4H, H]``, ``bh [*E, 4H]``, ``c, h [*E, B, H]``, ``reset [T, B]``;
returns ``(y [*E, T, B, H], (c, h) after the last step)``.

The recurrence is two ops of the ``r2d2dpg`` library, ``lstm_seq_fwd`` and
``lstm_seq_bwd``, in an autograd ``Function`` whose backward is the second.
On a CUDA tensor each launches ``csrc/lstm_seq.cu`` (built on first use,
see ``r2d2dpg_torch.kernels``) once, or raises; on a CPU tensor each runs
its plain version, ``lstm_seq_forward_plain`` / ``lstm_seq_backward_plain``,
the same math in PyTorch ops.  There is no other route.  The kernel takes
H in ``HIDDEN_SIZES``, any B, fewer than 2^31 gate values and float32 only;
it raises on anything else.  The forward saves the post-activation gates and ``c`` of
every step when a gradient is wanted; the backward returns ``dz`` (the
gradient of ``zx``) and the carry's, and the gradient of ``wh`` and ``bh``
are one product and one sum over the window's ``T*B`` rows here.

Each op has a FLOP formula for ``FlopCounterMode`` (``obs/device.py``'s
``count_flops``): the forward's ``h Wh^T`` of every step, the backward's
``dz Wh`` of every step whose carry takes a gradient (not step 0's, where
the initial carry takes none), as the step form's products count.
"""

from __future__ import annotations

import struct
from typing import Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from r2d2dpg_torch.kernels import LSTM_SEQ

HIDDEN_SIZES = (32, 128, 256)  # the kernel's H: a cluster of H / 32 blocks
ROWS = (2, 4, 8, 16)  # rows a cluster of the kernel may own

# The kernel's launch records, FwdArgs and BwdArgs in csrc/lstm_seq.cu.
_FWD_RECORD = struct.Struct("=16q")
_BWD_RECORD = struct.Struct("=16q")
_sm_count = {}


# ------------------------------------------------------------- plain version
def lstm_seq_forward_plain(
    zx: Tensor, wh: Tensor, bh: Tensor, c0: Tensor, h0: Tensor, reset: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(y [E, T, B, H], c after the last step, gates [E, T, B, 4H]
    post-activation, c [E, T, B, H] of every step)`` of the module docstring;
    ``reset`` is bool."""
    keep = ~reset[..., None]
    c, h = c0, h0
    ys, gates, cs = [], [], []
    for t in range(zx.shape[1]):
        c, h = torch.where(keep[t], c, 0.0), torch.where(keep[t], h, 0.0)
        z = (torch.matmul(h, wh.transpose(-1, -2)) + bh.unsqueeze(-2)) + zx[:, t]
        i, f, g, o = z.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        gates.append(torch.cat([i, f, g, o], -1))
        cs.append(c)
    return torch.stack(ys, 1), c, torch.stack(gates, 1), torch.stack(cs, 1)


def lstm_seq_backward_plain(
    dy: Tensor, dc_last: Tensor, wh: Tensor, gates: Tensor, cs: Tensor, c0: Tensor,
    reset: Tensor, carry_grad: bool,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dz [E, T, B, 4H], dc0, dh0)`` from the forward's saved gates and
    ``c``; ``dc0`` and ``dh0`` (the gradient of the carry before step 0's
    reset) are empty unless ``carry_grad``."""
    keep = ~reset[..., None]
    steps = dy.shape[1]
    dz = torch.empty_like(gates)
    dcc, dhc = dc_last, torch.zeros_like(dc_last)
    for t in reversed(range(steps)):
        i, f, g, o = gates[:, t].chunk(4, dim=-1)
        c_prev = torch.where(keep[t], cs[:, t - 1] if t > 0 else c0, 0.0)
        tc = torch.tanh(cs[:, t])
        dh = dy[:, t] + dhc
        dc = dcc + dh * o * (1.0 - tc * tc)
        dzt = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                         dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], -1)
        dz[:, t] = dzt
        dcc = torch.where(keep[t], dc * f, 0.0)
        if t > 0 or carry_grad:
            dhc = torch.where(keep[t], torch.matmul(dzt, wh), 0.0)
    if not carry_grad:
        return dz, dc_last.new_empty(0), dc_last.new_empty(0)
    return dz, dcc, dhc


# ------------------------------------------------------------------- kernel
def rows_per_cluster(members: int, batch: int, hidden: int, sms: int) -> int:
    """RC: the fewest rows a cluster of ``hidden / 32`` blocks owns such
    that every block of the grid fits on the card's ``sms`` at once (the
    most, 16, past that)."""
    blocks = hidden // 32
    for rc in ROWS:
        if members * -(-batch // rc) * blocks <= sms:
            return rc
    return ROWS[-1]


def _check(zx: Tensor, wh: Tensor, reset: Tensor, **others: Tensor):
    """Raise on what the kernel does not take; ``(E, T, B, H)``.  ``zx`` is
    ``[E, T, B, 4H]`` (or the gates); each of ``others`` is ``bias``-,
    ``carry``- or ``step``-shaped by its name's start: ``[E, 4H]``, ``[E, B,
    H]``, ``[E, T, B, H]``."""
    if wh.dim() != 3:
        raise ValueError(f"lstm_seq: need wh [E, 4H, H]; got {tuple(wh.shape)}")
    e, g, h = wh.shape
    if g != 4 * h or zx.dim() != 4 or zx.shape[0] != e or zx.shape[3] != g:
        raise ValueError(f"lstm_seq: need zx [E, T, B, 4H] beside wh {tuple(wh.shape)}; "
                         f"got {tuple(zx.shape)}")
    t, b = zx.shape[1:3]
    if t < 1:
        raise ValueError("lstm_seq: need 1 or more steps")
    shapes = {"bias": (e, g), "carry": (e, b, h), "step": (e, t, b, h)}
    for name, x in (("reset", reset), *others.items()):
        want = (t, b) if name == "reset" else shapes[name.split("_")[0]]
        if tuple(x.shape) != want:
            raise ValueError(f"lstm_seq: need {name} {want}; got {tuple(x.shape)}")
    if any(x.dtype != torch.float32 for x in (zx, wh, *others.values())):
        raise TypeError("lstm_seq: the tensors must be float32, reset bool")
    if reset.dtype != torch.bool:
        raise TypeError("lstm_seq: the tensors must be float32, reset bool")
    if any(x.device != zx.device for x in (wh, reset, *others.values())):
        raise ValueError("lstm_seq: every tensor must be on one device")
    if zx.is_cuda:
        if h not in HIDDEN_SIZES:
            raise ValueError(f"lstm_seq: the kernel takes hidden sizes {HIDDEN_SIZES}; got {h}")
        if b < 1:
            raise ValueError(f"lstm_seq: the kernel takes a batch of 1 or more; got {b}")
        if e * t * b * g >= 2**31:
            raise ValueError(f"lstm_seq: the kernel takes fewer than 2^31 gate values; got "
                             f"E {e}, T {t}, B {b}, H {h}")
    elif zx.device.type != "cpu":
        raise ValueError(f"lstm_seq: unsupported device {zx.device}")
    return e, t, b, h


def _stream_and_rows(x: Tensor, e: int, b: int, h: int) -> Tuple[int, int]:
    index = x.get_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return (torch._C._cuda_getCurrentRawStream(index),
            rows_per_cluster(e, b, h, _sm_count[index]))


def _launch(name: str, record: bytes, x: Tensor) -> None:
    launch = LSTM_SEQ.function(name)
    index = x.get_device()
    if index == torch._C._cuda_getDevice():
        err = launch(record)
    else:
        with torch.cuda.device(index):
            err = launch(record)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    # A launch recorded into a CUDA graph counts here once; replays do not.
    LSTM_SEQ.launches += 1


def _ptr(x: Tensor) -> int:
    return x.data_ptr() if x.numel() else 0


def _forward_impl(zx: Tensor, wh: Tensor, bh: Tensor, c0: Tensor, h0: Tensor,
                  reset: Tensor, save: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    e, t, b, h = _check(zx, wh, reset, bias=bh, carry_c=c0, carry_h=h0)
    if not zx.is_cuda:
        y, c_last, gates, cs = lstm_seq_forward_plain(zx, wh, bh, c0, h0, reset)
        return (y, c_last) + ((gates, cs) if save else (zx.new_empty(0), zx.new_empty(0)))
    zx, wh, bh, c0, h0, reset = (x.contiguous() for x in (zx, wh, bh, c0, h0, reset))
    y = zx.new_empty(e, t, b, h)
    c_last = zx.new_empty(e, b, h)
    gates = torch.empty_like(zx) if save else zx.new_empty(0)
    cs = torch.empty_like(y) if save else zx.new_empty(0)
    stream, rows = _stream_and_rows(zx, e, b, h)
    _launch("lstm_seq_forward", _FWD_RECORD.pack(
        zx.data_ptr(), wh.data_ptr(), bh.data_ptr(), c0.data_ptr(), h0.data_ptr(),
        reset.data_ptr(), y.data_ptr(), c_last.data_ptr(), _ptr(gates), _ptr(cs),
        e, t, b, h, rows, stream), zx)
    return y, c_last, gates, cs


def _backward_impl(dy: Tensor, dc_last: Tensor, wh: Tensor, gates: Tensor, cs: Tensor,
                   c0: Tensor, reset: Tensor, carry_grad: bool) -> Tuple[Tensor, Tensor, Tensor]:
    e, t, b, h = _check(gates, wh, reset, step_dy=dy, step_c=cs, carry_c=c0,
                        carry_dc=dc_last)
    if not dy.is_cuda:
        return lstm_seq_backward_plain(dy, dc_last, wh, gates, cs, c0, reset, carry_grad)
    dy, dc_last, wh, gates, cs, c0, reset = (
        x.contiguous() for x in (dy, dc_last, wh, gates, cs, c0, reset))
    dz = torch.empty_like(gates)
    dc0 = torch.empty_like(c0) if carry_grad else c0.new_empty(0)
    dh0 = torch.empty_like(c0) if carry_grad else c0.new_empty(0)
    stream, rows = _stream_and_rows(dy, e, b, h)
    _launch("lstm_seq_backward", _BWD_RECORD.pack(
        dy.data_ptr(), dc_last.data_ptr(), wh.data_ptr(), gates.data_ptr(), cs.data_ptr(),
        c0.data_ptr(), reset.data_ptr(), dz.data_ptr(), _ptr(dc0), _ptr(dh0),
        e, t, b, h, rows, stream), dy)
    return dz, dc0, dh0


# Two ops of the ``r2d2dpg`` library, so that ``FlopCounterMode`` sees them
# (their FLOP formulas below).  Registered with the plain library API: a
# ``torch.library.custom_op`` imports ``torch._dynamo`` at its first call,
# seconds of a process's set-up.
_LIB = torch.library.Library("r2d2dpg", "DEF")
_LIB.define("lstm_seq_fwd(Tensor zx, Tensor wh, Tensor bh, Tensor c0, Tensor h0, "
            "Tensor reset, bool save) -> (Tensor, Tensor, Tensor, Tensor)")
_LIB.define("lstm_seq_bwd(Tensor dy, Tensor dc_last, Tensor wh, Tensor gates, Tensor cs, "
            "Tensor c0, Tensor reset, bool carry_grad) -> (Tensor, Tensor, Tensor)")
_LIB.impl("lstm_seq_fwd", _forward_impl, "CompositeExplicitAutograd")
_LIB.impl("lstm_seq_bwd", _backward_impl, "CompositeExplicitAutograd")
# ``(y, c_last, gates, cs)``; ``gates`` and ``cs`` are empty unless ``save``.
lstm_seq_fwd = torch.ops.r2d2dpg.lstm_seq_fwd
# ``(dz, dc0, dh0)``; ``dc0`` and ``dh0`` are empty unless ``carry_grad``.
lstm_seq_bwd = torch.ops.r2d2dpg.lstm_seq_bwd


class _LSTMSequence(torch.autograd.Function):
    """The forward op, its backward the backward op; ``save`` is whether a
    gradient is wanted (the forward then keeps the gates and ``c``)."""

    @staticmethod
    def forward(ctx, zx, wh, bh, c0, h0, reset, save):
        y, c_last, gates, cs = lstm_seq_fwd(zx, wh, bh, c0, h0, reset, save)
        ctx.save_for_backward(wh, c0, h0, reset, y, gates, cs)
        return y, c_last

    @staticmethod
    def backward(ctx, dy, dc_last):
        wh, c0, h0, reset, y, gates, cs = ctx.saved_tensors
        need_zx, need_wh, need_bh, need_c0, need_h0 = ctx.needs_input_grad[:5]
        dz, dc0, dh0 = lstm_seq_bwd(dy, dc_last, wh, gates, cs, c0, reset, need_c0 or need_h0)
        dwh = dbh = None
        if need_wh:  # sum over t, b of dz_t^T h'_{t-1}, h' the carry after the reset
            h_prev = torch.cat([h0.unsqueeze(1), y[:, :-1]], 1)
            h_prev = torch.where(reset[None, :, :, None], 0.0, h_prev)
            dwh = torch.matmul(dz.flatten(1, 2).transpose(1, 2), h_prev.flatten(1, 2))
        if need_bh:
            dbh = dz.sum((1, 2))
        return (dz if need_zx else None, dwh, dbh, dc0 if need_c0 else None,
                dh0 if need_h0 else None, None, None)


@register_flop_formula(torch.ops.r2d2dpg.lstm_seq_fwd)
def _fwd_flops(zx_shape, wh_shape, *args, out_shape=None, **kwargs) -> int:
    e, t, b, g = zx_shape
    return 2 * e * t * b * g * wh_shape[-1]


@register_flop_formula(torch.ops.r2d2dpg.lstm_seq_bwd)
def _bwd_flops(dy_shape, dc_shape, wh_shape, gates_shape, cs_shape, c0_shape, reset_shape,
               carry_grad, out_shape=None, **kwargs) -> int:
    e, t, b, g = gates_shape
    return 2 * e * (t if carry_grad else t - 1) * b * g * wh_shape[-1]


def lstm_sequence(zx: Tensor, wh: Tensor, bh: Tensor, carry, reset: Tensor):
    """``(y [*E, T, B, H], (c, h) after the last step)``: the module
    docstring's recurrence, one kernel launch each way on a card."""
    c0, h0 = carry
    ens = wh.dim() == 3
    if not ens:
        zx, wh, bh, c0, h0 = (x.unsqueeze(0) for x in (zx, wh, bh, c0, h0))
    elif c0.dim() == 2:  # one carry for every member, as the step broadcasts it
        c0, h0 = (x.expand(wh.shape[0], *x.shape) for x in (c0, h0))
    reset = reset.bool()
    save = torch.is_grad_enabled() and any(
        x.requires_grad for x in (zx, wh, bh, c0, h0))
    y, c_last = _LSTMSequence.apply(zx, wh, bh, c0, h0, reset, save)
    if not ens:
        y, c_last = y[0], c_last[0]
    return y, (c_last, y[..., -1, :, :])
