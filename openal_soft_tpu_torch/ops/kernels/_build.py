"""Build, load and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use with nvcc into ``openal_soft_tpu_torch/_build/lib<name>-<hash>.so``
(the hash covers the source, every header it includes from its own
directory or ``csrc/``, and the flags, so an edited source or header
rebuilds), then loaded with ctypes.  Nothing is built when a module is imported, and
only the repository's own sources are compiled.  A failed build raises with
nvcc's output.  ``check_tensor`` holds a tensor to the layout a kernel's
C interface assumes before its pointer is passed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # nvcc's output per built library


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def included_headers(src: Path) -> list[Path]:
    """The quoted includes of ``src``, and theirs, in first-seen order,
    each found as nvcc finds it: beside the including file, else in
    ``csrc/`` (the ``-I``).  An include found in neither is left to nvcc."""
    seen: list[Path] = []
    todo = [Path(src)]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_bytes()):
            rel = name.decode()
            for base in (cur.parent, SRC_DIR):
                cand = (base / rel).resolve()
                if cand.is_file():
                    if cand not in seen:
                        seen.append(cand)
                        todo.append(cand)
                    break
    return seen


def source_digest(src: Path) -> str:
    """16 hex digits over the source, its included headers and the flags."""
    h = hashlib.sha256(Path(src).read_bytes())
    for hdr in included_headers(src):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, src: Path | None = None) -> Path:
    """Compile csrc/<name>.cu (or ``src``) unless an up-to-date library
    exists."""
    src = SRC_DIR / f"{name}.cu" if src is None else Path(src)
    so = BUILD_DIR / f"lib{name}-{source_digest(src)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, f"-I{SRC_DIR}", "-o", tmp, str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name} "
                               f"(exit {res.returncode}):\n{res.stderr}"
                               f"{res.stdout}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_logs[name] = res.stderr + res.stdout
    return so


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ctypes library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def check_tensor(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless x is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
