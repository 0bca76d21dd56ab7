"""The CUDA kernels' build cache (apex_tpu_torch.csrc), on the CPU: no
nvcc is run.  A library's file name must change whenever anything that
nvcc reads from this directory changes — the source and every header it
includes by a local `#include "..."`, followed through the headers — so
an edited shared header (hopper.cuh) is never served from a stale build,
and must not change for a header no source includes."""

import os
import shutil

import pytest

from apex_tpu_torch import csrc

_SOURCES = sorted(f[:-3] for f in os.listdir(csrc._DIR) if f.endswith(".cu"))


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the kernel sources and headers, which csrc then reads."""
    for f in os.listdir(csrc._DIR):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(csrc._DIR, f), tmp_path / f)
    monkeypatch.setattr(csrc, "_DIR", str(tmp_path))
    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


@pytest.mark.parametrize("name", ["fused_dense", "flash_attention"])
def test_so_path_follows_the_shared_header(tree, name):
    assert str(tree / "hopper.cuh") in csrc.local_includes(
        csrc.source_path(name))
    before = csrc._so_path(name)
    _append(tree / "hopper.cuh", "\n// edited\n")
    after = csrc._so_path(name)
    assert after != before
    assert os.path.dirname(after) == str(tree / "build")


@pytest.mark.parametrize("name", _SOURCES)
def test_so_path_follows_the_source(tree, name):
    before = csrc._so_path(name)
    _append(tree / f"{name}.cu", "\n// edited\n")
    assert csrc._so_path(name) != before


@pytest.mark.parametrize("name", _SOURCES)
def test_so_path_ignores_a_header_no_source_includes(tree, name):
    (tree / "unused.cuh").write_text("// nobody includes this\n")
    before = csrc._so_path(name)
    _append(tree / "unused.cuh", "#define CHANGED 1\n")
    assert csrc._so_path(name) == before


def test_nested_local_includes_are_followed(tree):
    (tree / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tree / "inner.cuh").write_text("#pragma once\n")
    (tree / "probe.cu").write_text(
        '#include <cuda_runtime.h>\n  #  include "outer.cuh"\n'
        '#include "outer.cuh"\n')
    assert csrc.local_includes(str(tree / "probe.cu")) == [
        str(tree / "outer.cuh"), str(tree / "inner.cuh")]
    before = csrc._so_path("probe")
    _append(tree / "inner.cuh", "// edited\n")
    assert csrc._so_path("probe") != before


@pytest.mark.parametrize("name", _SOURCES)
def test_every_local_include_exists(name):
    for path in csrc.local_includes(csrc.source_path(name)):
        assert os.path.isfile(path), f"{name}.cu includes missing {path}"


def _ablation_script():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "port_hopper_ablation.py")
    spec = importlib.util.spec_from_file_location("port_hopper_ablation",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["fused_dense", "flash_attention"])
def test_ablation_overrides_are_declared(name):
    """Every `-D` override that scripts/port_hopper_ablation.py passes to
    nvcc names a macro that the source it builds declares with an
    `#ifndef` default, so a renamed or removed knob fails here instead
    of building the shipped kernel under a variant's name."""
    import re

    variants = _ablation_script().OVERRIDES[name]
    with open(csrc.source_path(name)) as f:
        declared = set(re.findall(r"^#ifndef (APEX_\w+)", f.read(), re.M))
    passed = {d[2:].split("=")[0] for defs in variants.values()
              for d in defs}
    assert passed, name
    assert passed <= declared, sorted(passed - declared)
    assert all(d.startswith("-D") and "=" in d
               for defs in variants.values() for d in defs)
