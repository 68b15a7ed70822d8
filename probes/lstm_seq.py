#!/usr/bin/env python3
"""Time the LSTM recurrence kernel against the step unroll it replaces.

    python3 probes/lstm_seq.py [--ptxas] [--check] [--calls N]

From the root of a checkout, on a machine with one CUDA card.  ``--ptxas``
first compiles ``r2d2dpg_torch/csrc/lstm_seq.cu`` once more with ``-Xptxas
-v`` and prints what the assembler reports of each kernel (registers,
spills, shared memory).  ``--check`` runs ``chip_smoke.py``'s LSTM leg
(the kernel against its plain version at every shape of
``LSTM_SEQ_SHAPES``, a CUDA graph's replays, a refused shape).  Then one
JSON line for each of walker_r2d2's and cheetah_pixels' learner shapes
(hidden 256; E ensemble members, T steps, B rows), each time the device
time a call (torch.profiler's CUPTI events; CUDA events where it sees
none) over ``--calls`` calls:

- ``kernel_fwd_ms``, ``kernel_fwd_nosave_ms``, ``kernel_bwd_ms``: one
  launch of the kernel forward (saving the gates and ``c`` for the
  backward, and not), and backward, and ``*_us_per_step`` over T;
- ``step_*``: the LSTM core over the window step by step, as the learner
  ran it before (``_Core.forward`` of each step: the reset's selects, both
  products, the gates), without a gradient (``fwd``) and with the
  parameters' gradient (``fwdbwd``); ``seq_*``: the same in the sequence
  form (the input projection over ``T*B`` rows and the kernel); with each
  its device kernels a call;
- ``bound_us``: the recurrence's products (``h Wh^T`` of every step) at the
  card's float32 peak, 67 TFLOP/s: the least time for the forward's work.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FP32_PEAK = 67e12
# (label, E, T, B): the core's learner shapes at hidden 256.
SHAPES = (
    ("walker_unroll", 1, 20, 64),
    ("walker_targets", 1, 23, 64),
    ("walker_burnin_fused", 2, 20, 64),
    ("cheetah_unroll", 1, 20, 32),
    ("cheetah_targets", 1, 25, 32),
    ("cheetah_burnin_fused", 2, 20, 32),
)
HIDDEN = 256


def ptxas() -> None:
    from r2d2dpg_torch import kernels

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lstm_seq.so"), str(kernels.LSTM_SEQ.source)],
            capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    print(json.dumps({"ptxas": lines}), flush=True)


def timing(torch, dev, label, e, t, b, calls):
    from torch import nn
    from torch.func import functional_call

    from chip_smoke import _device_profile, _event_ms
    from r2d2dpg_torch.models.actor_critic import _Core, unroll
    from r2d2dpg_torch.ops.lstm_seq import lstm_seq_bwd, lstm_seq_fwd

    h = HIDDEN
    core = _Core(h, h, True)

    class Seq(nn.Module):
        def __init__(self):
            super().__init__()
            self.core = core

        def forward(self, x, carry, reset):
            return self.core.sequence(x, carry, reset)

    seq = Seq()
    g = torch.Generator().manual_seed(e * t + b)
    lead = () if e == 1 else (e,)
    base = {k: v.detach() for k, v in core.named_parameters()}
    params = {k: (v if e == 1 else torch.stack([v] * e)).clone().to(dev).requires_grad_()
              for k, v in base.items()}
    seq_params = {f"core.{k}": v for k, v in params.items()}
    x = torch.randn(*lead, t, b, h, generator=g).to(dev)
    x_tm = x.movedim(-3, 0).contiguous()  # [T, *E, B, H]
    carry = tuple(0.5 * torch.randn(*lead, b, h, generator=g).to(dev) for _ in range(2))
    reset = (torch.rand(t, b, generator=g) < 0.05).to(dev)
    reset_f = reset.float()

    def step_fwd():
        with torch.no_grad():
            return unroll(lambda c, xt, r: functional_call(core, params, (xt, c, r)),
                          carry, x_tm, reset_f)

    def seq_fwd():
        with torch.no_grad():
            return functional_call(seq, seq_params, (x, carry, reset))

    def step_fwdbwd():
        y, _ = unroll(lambda c, xt, r: functional_call(core, params, (xt, c, r)),
                      carry, x_tm, reset_f)
        return torch.autograd.grad(y.square().sum(), list(params.values()))

    def seq_fwdbwd():
        y, _ = functional_call(seq, seq_params, (x, carry, reset))
        return torch.autograd.grad(y.square().sum(), list(params.values()))

    zx = torch.randn(e, t, b, 4 * h, generator=g).to(dev)
    wh = params["cell.wh"].detach().reshape(e, 4 * h, h).contiguous()
    bh = params["cell.bh"].detach().reshape(e, 4 * h).contiguous()
    c0, h0 = (c.reshape(e, b, h).contiguous() for c in carry)
    _, _, gates, cs = lstm_seq_fwd(zx, wh, bh, c0, h0, reset, True)
    dy = torch.randn(e, t, b, h, generator=g).to(dev)
    dc = torch.zeros(e, b, h, device=dev)
    fns = {
        "kernel_fwd": lambda: lstm_seq_fwd(zx, wh, bh, c0, h0, reset, True),
        "kernel_fwd_nosave": lambda: lstm_seq_fwd(zx, wh, bh, c0, h0, reset, False),
        "kernel_bwd": lambda: lstm_seq_bwd(dy, dc, wh, gates, cs, c0, reset, False),
        "step_fwd": step_fwd, "seq_fwd": seq_fwd,
        "step_fwdbwd": step_fwdbwd, "seq_fwdbwd": seq_fwdbwd,
    }
    rec = {"shape": label, "e": e, "t": t, "b": b, "h": h}
    events = _event_ms(fns, calls)
    for name, fn in fns.items():
        ms, top, kernels_per_call = _device_profile(fn, calls)
        rec[f"{name}_ms"] = ms if ms is not None else events[name]
        rec[f"{name}_timing"] = "profiler" if ms is not None else "events"
        rec[f"{name}_event_ms"] = events[name]
        rec[f"{name}_kernels"] = kernels_per_call
        if name.startswith("kernel"):
            rec[f"{name}_us_per_step"] = rec[f"{name}_ms"] * 1e3 / t
    rec["bound_us"] = 2 * e * t * b * 4 * h * h / FP32_PEAK * 1e6
    for form in ("fwd", "fwdbwd"):
        rec[f"step_over_seq_{form}"] = rec[f"step_{form}_ms"] / rec[f"seq_{form}_ms"]
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--calls", type=int, default=50)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lstm_seq probe: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import _card_line, _lstm_seq_phase
    from r2d2dpg_torch.kernels import LSTM_SEQ

    dev = torch.device("cuda")
    _, name, limit = _card_line()
    print(json.dumps({"card": name, "power_limit": limit}), flush=True)
    if args.ptxas:
        ptxas()
    LSTM_SEQ.library()
    if args.check:
        _lstm_seq_phase(torch, dev)
    for label, e, t, b in SHAPES:
        print(json.dumps(timing(torch, dev, label, e, t, b, args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
