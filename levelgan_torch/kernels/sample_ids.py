"""The export's Gumbel sampling head as one kernel: logits and uniforms in,
uint8 tile ids out.

``gumbel_ids(logits, u, tau)`` gives what ``decode(gumbel_softmax(logits,
tau, hard=True))`` gives with the uniforms ``u`` that
``ops.gumbel.gumbel_noise`` draws: the first index of the largest
``softmax((logits - log(-log(max(u, tiny)))) / tau)`` over the last axis,
bit for bit, ties included.  ``models.heads.sample_ids`` routes the export
and the quality probe here.  Replaces no TPU kernel (the JAX package
samples with XLA operations); it was added because those operations took
44% of the export's device time on an H100.  CUDA source, with its design:
``levelgan_torch/csrc/sample_ids.cu``.

On a CPU tensor the wrapper runs the plain version, which is that chain of
PyTorch operations itself; on a CUDA tensor it launches the kernel or
raises.  Both check their inputs alike.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from levelgan_torch import obs
from levelgan_torch.kernels import build

MAX_TILES = 32        # the kernel's largest T (a template parameter)


def gumbel_ids_plain(logits: torch.Tensor, u: torch.Tensor,
                     tau) -> torch.Tensor:
    """The plain version: ``gumbel_noise``'s transform of ``u``, then
    ``gumbel_softmax``'s softmax and the argmax that ``decode`` takes."""
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    y = torch.softmax((logits + g) / tau, dim=-1)
    return torch.argmax(y, dim=-1).to(torch.uint8)


def inv_tau(tau) -> float:
    """``1.0f / (float)tau``: the factor PyTorch multiplies a CUDA tensor by
    when it divides it by the CPU scalar ``tau``."""
    return float(np.float32(1.0) / np.float32(tau))


def _lib():
    lib = build.load("sample_ids")
    fn = lib.sample_ids
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ctypes.c_float, ptr, ctypes.c_longlong,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return lib


def _check(logits: torch.Tensor, u: torch.Tensor) -> int:
    t = logits.shape[-1] if logits.dim() else 0
    for name, x in (("logits", logits), ("u", u)):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.shape != logits.shape or x.device != logits.device):
            raise ValueError(
                f"sample_ids: {name} must be contiguous f32 "
                f"{tuple(logits.shape)} on {logits.device}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
                + ("" if x.is_contiguous() else ", not contiguous"))
    if not 1 <= t <= MAX_TILES:
        raise ValueError(f"sample_ids: the kernel takes 1 to {MAX_TILES} "
                         f"tiles on the last axis, got {t}")
    return t


def gumbel_ids(logits: torch.Tensor, u: torch.Tensor, tau) -> torch.Tensor:
    """logits, u f32 [..., T] (contiguous, T <= 32) -> uint8 ids [...]."""
    t = _check(logits, u)
    if logits.device.type == "cpu":
        return gumbel_ids_plain(logits, u, tau)
    ids = torch.empty(logits.shape[:-1], dtype=torch.uint8,
                      device=logits.device)
    n = ids.numel()
    if n:
        with torch.cuda.device(logits.device):
            err = _lib().sample_ids(build.ptr(logits), build.ptr(u),
                                    inv_tau(tau), build.ptr(ids), n, t,
                                    build.stream_ptr(logits.device))
        build.check(err, f"sample_ids at [{n}, {t}]")
        obs.count("head.launches")
    return ids
