"""Build and bind the port's host C routines (``levelgan_torch/native``).

``unpack.c`` (the export's bit-plane unpack) and ``corpusgen.c`` (the
synthetic corpus carver of ``data.corpus='synthetic_native'``, a copy of
the JAX package's) are each compiled with the system C compiler (``cc
-O3 -shared -fPIC``) at first use into ``levelgan_torch/_build/`` (listed
in ``.gitignore``), under a name that carries a hash of the source, so a
stale library is never loaded, and bound with ``ctypes``.  A failed build
raises with the compiler's message: there is no NumPy fallback on this
path (``export.unpack_levels_plain`` is the plain version the tests hold
the unpack to; ``data.dataset.synthetic_corpus`` is the NumPy carver, a
different random stream).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# argument and result types of each library's entry point
_SIGNATURES = {
    "unpack": ("unpack_planes", [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int32, ctypes.c_void_p]),
    "corpusgen": ("gen_levels", [ctypes.c_uint64, ctypes.c_int64,
                                 ctypes.c_int32, ctypes.c_double,
                                 ctypes.c_double, ctypes.c_double,
                                 ctypes.c_double, ctypes.c_void_p]),
}


def _lib_path(stem: str) -> Path:
    src = _DIR / f"{stem}.c"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{stem}-{digest}.so"


def _compile(stem: str) -> Path:
    out = _lib_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["cc", "-O3", "-shared", "-fPIC", "-o", tmp, str(_DIR / f"{stem}.c")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {stem}.c failed: {e}") from e
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"cc failed for {stem}.c:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``native/<stem>.c``, built if needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(stem)))
            if stem in _SIGNATURES:
                name, argtypes = _SIGNATURES[stem]
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _libs[stem] = lib
        return lib


def unpack_planes(packed: np.ndarray, bits: int, out: np.ndarray) -> None:
    """The bit-plane wire format unpacked by ``unpack.c``.

    ``packed``: C-contiguous uint8, n_groups * bits bytes in the [group,
    plane] layout; ``out``: C-contiguous uint8 of n_groups * 8 bytes (one
    tile id per byte), written whole.
    """
    if not (packed.flags.c_contiguous and out.flags.c_contiguous):
        raise ValueError("unpack_planes needs C-contiguous arrays")
    if packed.dtype != np.uint8 or out.dtype != np.uint8:
        raise ValueError("unpack_planes takes uint8 arrays")
    n_groups = packed.size // bits
    if packed.size != n_groups * bits or out.size != n_groups * 8:
        raise ValueError(f"{packed.size} packed bytes at {bits} bits do not "
                         f"fill {out.size} tiles")
    rc = load("unpack").unpack_planes(packed.ctypes.data, n_groups, bits,
                                      out.ctypes.data)
    if rc:
        raise RuntimeError(f"unpack_planes failed with code {rc}")


def synthetic_corpus_native(n: int, size: int, seed: int = 1234,
                            wall_density: float = 0.25,
                            hazard_rate: float = 0.04,
                            coin_rate: float = 0.06,
                            rate_oversample: float = 0.0) -> np.ndarray:
    """``n`` carved levels [n, size, size] uint8 from ``corpusgen.c``: the
    JAX package's native carver, bit for bit (xoshiro256** seeded by
    splitmix64, its own stream: deterministic in ``seed``, a different
    corpus from the NumPy carver's)."""
    out = np.empty((n, size, size), np.uint8)
    rc = load("corpusgen").gen_levels(seed, n, size, wall_density,
                                      hazard_rate, coin_rate,
                                      rate_oversample, out.ctypes.data)
    if rc:
        raise RuntimeError(f"gen_levels failed with code {rc}")
    return out
