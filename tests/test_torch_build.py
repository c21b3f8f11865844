"""The kernel build's cache key: a library is rebuilt when its source, a
header the source includes, or the flags change.  No nvcc is needed: the
compiler is replaced by a stub that records its command."""

import subprocess
from pathlib import Path

from openal_soft_tpu_torch.ops.kernels import _build


def _tree(tmp_path: Path) -> tuple[Path, Path, Path]:
    src = tmp_path / "k.cu"
    hdr = tmp_path / "a.cuh"
    inner = tmp_path / "b.cuh"
    src.write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n'
                   'int k;\n')
    hdr.write_text('#pragma once\n#include "b.cuh"\nint a;\n')
    inner.write_text("int b;\n")
    return src, hdr, inner


def test_digest_covers_every_included_header(tmp_path):
    src, hdr, inner = _tree(tmp_path)
    assert _build.included_headers(src) == [hdr.resolve(), inner.resolve()]
    d0 = _build.source_digest(src)
    assert _build.source_digest(src) == d0
    inner.write_text("int b2;\n")          # a header of a header
    d1 = _build.source_digest(src)
    hdr.write_text('#pragma once\n#include "b.cuh"\nint a2;\n')
    d2 = _build.source_digest(src)
    src.write_text(src.read_text() + "int k2;\n")
    assert len({d0, d1, d2, _build.source_digest(src)}) == 4


def test_both_resamplers_include_the_shared_window_header():
    hdr = (_build.SRC_DIR / "resample_window.cuh").resolve()
    for name in ("resample_gen", "resample_span"):
        assert _build.included_headers(
            _build.SRC_DIR / f"{name}.cu") == [hdr]


def test_unit_and_voice_resamplers_include_the_shared_window_header():
    """K1 stages its windows with the header's plan and staging, and K5 is
    its window kernel behind a third entry point."""
    hdr = (_build.SRC_DIR / "resample_window.cuh").resolve()
    for name in ("resample_unit", "resample_voice"):
        assert _build.included_headers(
            _build.SRC_DIR / f"{name}.cu") == [hdr]


def test_build_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    """build() passes -I csrc/ to nvcc, reuses a library whose source and
    headers are unchanged, and compiles anew after a header edit."""
    src, hdr, _ = _tree(tmp_path)
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    first = _build.build("k", src)
    assert f"-I{_build.SRC_DIR}" in calls[0] and first.exists()
    assert _build.build("k", src) == first and len(calls) == 1
    hdr.write_text('#pragma once\n#include "b.cuh"\nint a3;\n')
    second = _build.build("k", src)
    assert second != first and second.exists() and len(calls) == 2
