"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; the CPU only when asked for explicitly.

    Raises ``RuntimeError`` when a CUDA device is wanted (explicitly or by
    default) and none is present: there is no silent CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (or --device cpu) "
            "to run the plain PyTorch path on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ('bfloat16', 'float32', ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
