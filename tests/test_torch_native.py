"""The port's native unpack (``levelgan_torch/native/unpack.c``) against the
JAX package's ``unpack_levels`` and the port's NumPy form, bit for bit."""

import numpy as np
import pytest
import torch

from levelgan.export import unpack_levels as j_unpack_levels
from levelgan_torch import export as texport
from levelgan_torch.native import build as nbuild
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("bits", range(1, 8))
@pytest.mark.parametrize("b", [1, 3, 7])
def test_native_unpack_matches_jax_and_plain(bits, b):
    rng = np.random.default_rng(10 * bits + b)
    size = 16 if b != 7 else 8
    ids = rng.integers(0, 2 ** bits, (b, size, size), dtype=np.uint8)
    packed = texport.pack_levels(torch.from_numpy(ids), bits).numpy()
    got = texport.unpack_levels(packed, size)
    np.testing.assert_array_equal(got, ids)
    np.testing.assert_array_equal(got, j_unpack_levels(packed, size))
    np.testing.assert_array_equal(
        got, texport.unpack_levels_plain(packed, size))
    # into a preallocated, uninitialised slice of a larger result
    out = np.full((b + 2, size, size), 255, np.uint8)
    texport.unpack_levels(packed, size, out=out[1:b + 1])
    np.testing.assert_array_equal(out[1:b + 1], ids)
    assert (out[0] == 255).all() and (out[-1] == 255).all()


def test_native_unpack_refuses_bad_arrays():
    packed = np.zeros((2, 24), np.uint8)
    with pytest.raises(ValueError, match="fill"):
        nbuild.unpack_planes(packed, 3, np.empty((2, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        nbuild.unpack_planes(packed, 3, np.empty((2, 8, 16), np.uint8)[..., ::2])


def test_build_names_the_library_by_source_hash_and_raises(tmp_path,
                                                           monkeypatch):
    path = nbuild._lib_path("unpack")
    assert path.parent == nbuild.BUILD_DIR
    assert path.name.startswith("unpack-") and path.suffix == ".so"
    (tmp_path / "broken.c").write_text("int f( {\n")
    monkeypatch.setattr(nbuild, "_DIR", tmp_path)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="broken.c"):
        nbuild.load("broken")
    assert not list((tmp_path / "_build").glob("*.so"))
