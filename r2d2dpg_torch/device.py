"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device; raise without a card.

    A missing card is an error, never a quiet move to the CPU: a caller who
    wants the CPU says so (``device="cpu"``, CLI ``--device cpu``).  Also
    pins float32 matmuls and convolutions to full precision (no TF32), as the
    JAX reference runs at ``highest`` matmul precision, and bf16 matmuls to
    float32 sums (no reduced-precision split-K reductions), as XLA sums them.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def device_name(device: torch.device) -> str:
    """Human-readable name of ``device`` (the card's name on CUDA)."""
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type
