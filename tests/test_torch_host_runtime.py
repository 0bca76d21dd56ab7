"""The port's host runtime (apex_tpu_torch/csrc/host_runtime.cpp, built
with g++ at first use) against the JAX package's (apex_tpu.csrc), bit
for bit.  Each test first asserts that `apex_tpu.csrc.available()` is
true, so the JAX side is its C++ and not its numpy fallback (whose
shuffle is another permutation).  Also: the port's build never goes to
nvcc, builds under a temporary name, and raises, with no fallback, when
g++ is missing."""

import os

import numpy as np
import pytest

from apex_tpu import csrc as jcsrc
from apex_tpu_torch import csrc


@pytest.fixture(autouse=True)
def _jax_side_is_its_cpp():
    assert jcsrc.available(), "the JAX package's host runtime did not build"


@pytest.mark.parametrize("align", [1, 4, 128])
def test_flat_layout_matches(align):
    sizes = np.random.RandomState(align).randint(0, 1000, 37)
    got, total = csrc.flat_layout(sizes, align)
    want, jtotal = jcsrc.flat_layout(sizes, align)
    np.testing.assert_array_equal(got, want)
    assert total == jtotal
    offsets, total = csrc.flat_layout([100, 50, 128], align=128)
    np.testing.assert_array_equal(offsets, [0, 128, 256])
    assert total == 384


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_chunk_plan_matches(chunk):
    sizes = [5, 12, 0, 130, 1]
    np.testing.assert_array_equal(csrc.chunk_plan(sizes, chunk),
                                  jcsrc.chunk_plan(sizes, chunk))
    if chunk == 5:
        np.testing.assert_array_equal(
            csrc.chunk_plan([5, 12], 5),
            [(0, 0, 5), (1, 0, 5), (1, 5, 5), (1, 10, 2)])


@pytest.mark.parametrize("n,seed", [(1, 0), (1000, 42), (4096, 2 ** 40 + 7),
                                    (257, 3)])
def test_shuffle_indices_is_the_jax_packages_permutation(n, seed):
    got = csrc.shuffle_indices(n, seed)
    np.testing.assert_array_equal(got, jcsrc.shuffle_indices(n, seed))
    assert sorted(got.tolist()) == list(range(n))


def test_gather_rows_matches():
    rng = np.random.RandomState(0)
    ds = rng.randn(50, 3, 4).astype(np.float32)
    idx = rng.randint(0, 50, 33)
    np.testing.assert_array_equal(csrc.gather_rows(ds, idx),
                                  jcsrc.gather_rows(ds, idx))
    ds_i = rng.randint(-9, 9, (10, 3)).astype(np.int32)
    np.testing.assert_array_equal(csrc.gather_rows(ds_i, [9, 1], 2),
                                  jcsrc.gather_rows(ds_i, [9, 1], 2))


def test_gather_rows_checks_its_inputs():
    with pytest.raises(TypeError, match="float32 or int32"):
        csrc.gather_rows(np.zeros((4, 2)), [0])
    with pytest.raises(IndexError):
        csrc.gather_rows(np.zeros((4, 2), np.float32), [4])


def test_host_build_uses_gxx_not_nvcc(tmp_path, monkeypatch):
    """A fresh build: g++ with the stated flags on the .cpp, into a
    temporary name renamed into place under build/; no nvcc."""
    import subprocess

    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path))
    seen = []
    real = subprocess.run

    def spy(cmd, **kw):
        seen.append(list(cmd))
        return real(cmd, **kw)

    monkeypatch.setattr(subprocess, "run", spy)
    so = csrc.build_host()
    assert len(seen) == 1 and os.path.basename(seen[0][0]) == "g++"
    assert seen[0][1:1 + len(csrc.GXX_FLAGS)] == list(csrc.GXX_FLAGS)
    assert seen[0][-3:-1] == [csrc.HOST_SOURCE, "-o"]
    assert seen[0][-1].endswith(".tmp") and not os.path.exists(seen[0][-1])
    assert so == csrc.host_so_path() and os.path.exists(so)
    assert os.path.dirname(so) == str(tmp_path)
    assert not any("nvcc" in " ".join(c) for c in seen)
    assert csrc.build_host() == so and len(seen) == 1   # built once


def test_no_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(csrc, "_HOST", None)
    monkeypatch.setattr(csrc.shutil, "which", lambda name: None)
    with pytest.raises(csrc.HostBuildError, match="g\\+\\+ not found"):
        csrc.shuffle_indices(4, 0)
    assert csrc.available() is False


def test_nvcc_sources_are_the_cu_files_only():
    """`csrc.build` takes kernel names, each a `<name>.cu`; the .cpp is
    not one of them."""
    assert csrc.source_path("host_runtime").endswith("host_runtime.cu")
    assert not os.path.exists(csrc.source_path("host_runtime"))
    assert os.path.exists(csrc.HOST_SOURCE)
