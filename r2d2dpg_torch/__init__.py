"""PyTorch/CUDA port of r2d2dpg_tpu, beside the JAX package it is held against.

The port mirrors the JAX package's module names (``ops``, ``models``,
``replay``, ``agents``, ``envs``, ``training``, ``configs``, ``fleet``,
``train``) so a reader finds each counterpart by name.  It imports neither JAX nor anything
of ``r2d2dpg_tpu``; constants it shares with the JAX package are copied.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that request it raises
(``r2d2dpg_torch.device.resolve_device``).  The one TPU kernel of the JAX
package, the priority scatter, is a hand-written CUDA kernel here
(``csrc/priority_scatter.cu``, wrapped by ``ops/scatter.py``).
"""

from r2d2dpg_torch.device import resolve_device

__all__ = ["resolve_device"]
