"""Build and load the port's CUDA kernels (``levelgan_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  Builds happen at first use, into
``levelgan_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the sources, so a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source at once.

Every exported launch function returns ``cudaGetLastError()``; ``check``
raises on a non-zero value.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA toolkit required to build the "
                       "port's kernels)")


def _lib_path(stem: str) -> Path:
    h = hashlib.sha1()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def _compile(stem: str) -> Path:
    out = _lib_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
           "-o", tmp, str(CSRC / f"{stem}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[stem] = proc.stdout + proc.stderr
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{build_logs[stem]}")
    os.replace(tmp, out)
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs[stem] = ctypes.CDLL(str(_compile(stem)))
        return lib


def build_all() -> dict[str, float]:
    """Build every source in parallel; returns seconds per source."""
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    secs: dict[str, float] = {}
    errors: list[BaseException] = []

    def one(stem):
        t0 = time.perf_counter()
        try:
            _compile(stem)
        except BaseException as e:  # re-raised below, after every build ended
            errors.append(e)
        secs[stem] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(s,)) for s in stems]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for s in stems:
        load(s)
    return secs


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
