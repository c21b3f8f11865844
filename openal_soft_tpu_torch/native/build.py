"""Build the port's host-side C/C++: the output limiter and the C ABI.

Everything is compiled at first use with g++/gcc into
``openal_soft_tpu_torch/_build/``; a digest of the sources, the flags and
the Python it embeds picks the output name, so an edited source rebuilds
and concurrent builders never see a half-written file.  A failed build
raises with the compiler's output.

- ``build_limiter()``: ``limiter.cpp`` -> ``liblimiter-<hash>.so`` (ctypes,
  ``core/mastering.py``).
- ``build_shim()``: ``alc_shim.cpp``, ``shim_runtime.cpp`` and the
  ``shim_generated.cpp`` that ``gen_shim.py`` writes at build time ->
  ``shim-<hash>/libopenal_torch.so``, the classic OpenAL export surface
  over ``openal_soft_tpu_torch.al.api`` (it embeds CPython).
- ``build_client(name)``: ``<name>.c`` (``test_shim``, ``scene_client``)
  linked against that library into the same directory.

``client_env()`` is the environment a C client runs in: the embedded
interpreter gets this interpreter's ``sys.path``, and
``OPENAL_TORCH_DEVICE`` names the torch device the C ABI renders on.

    python -m openal_soft_tpu_torch.native.build   # builds all, prints paths
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
LIB_NAME = "libopenal_torch.so"
CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-std=c++17")
SHIM_SOURCES = ("alc_shim.cpp", "shim_runtime.cpp", "shim_runtime.h",
                "gen_shim.py")
CLIENTS = ("test_shim", "scene_client")

_lock = threading.Lock()


def _digest(paths, *extra: str) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(Path(p).name.encode() + b"\0" + Path(p).read_bytes())
    for e in extra:
        h.update(e.encode() + b"\0")
    return h.hexdigest()[:16]


def _run(cmd: list[str], what: str, **kw) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if res.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr}{res.stdout}")
    return res


def _compiler(name: str) -> str:
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found on PATH")
    return found


def python_flags() -> tuple[list[str], list[str]]:
    """(compile, link) flags that embed this interpreter: what
    ``python3-config --includes`` / ``--ldflags --embed`` print, read from
    the running interpreter's sysconfig so the library embeds the Python
    that built it."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ldver = sysconfig.get_config_var("LDVERSION")
    return ([f"-I{inc}"],
            [f"-L{libdir}", f"-lpython{ldver}", f"-Wl,-rpath,{libdir}",
             "-ldl", "-lm"])


def _publish(tmp: Path, final: Path) -> None:
    """Move a finished file or directory into place; a concurrent builder
    that got there first wins and ours is dropped."""
    try:
        os.rename(tmp, final)
    except OSError:
        if not final.exists():
            raise
        if tmp.is_dir():
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            tmp.unlink(missing_ok=True)


def build_limiter() -> Path:
    """liblimiter-<hash>.so from limiter.cpp (plain C interface, libm)."""
    src = SRC_DIR / "limiter.cpp"
    flags = ("-O2", "-shared", "-fPIC")
    so = BUILD_DIR / f"liblimiter-{_digest([src], *flags)}.so"
    with _lock:
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            _run([_compiler("g++"), *flags, "-o", tmp, str(src)],
                 "g++ (limiter.cpp)")
            _publish(Path(tmp), so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def shim_dir() -> Path:
    """The directory that holds this source tree's libopenal_torch.so."""
    cflags, lflags = python_flags()
    return BUILD_DIR / ("shim-" + _digest(
        [SRC_DIR / n for n in SHIM_SOURCES], *CXXFLAGS, *cflags, *lflags,
        sys.version))


def build_shim() -> Path:
    """shim-<hash>/libopenal_torch.so; gen_shim.py writes the generated
    half of the export surface into the build directory first."""
    out = shim_dir()
    lib = out / LIB_NAME
    with _lock:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="shim-tmp-", dir=BUILD_DIR))
        try:
            gen = _run([sys.executable, str(SRC_DIR / "gen_shim.py")],
                       "gen_shim.py")
            (tmp / "shim_generated.cpp").write_text(gen.stdout)
            cflags, lflags = python_flags()
            _run([_compiler("g++"), *CXXFLAGS, "-shared", *cflags,
                  f"-I{SRC_DIR}", "-o", str(tmp / LIB_NAME),
                  str(SRC_DIR / "alc_shim.cpp"),
                  str(SRC_DIR / "shim_runtime.cpp"),
                  str(tmp / "shim_generated.cpp"), *lflags],
                 f"g++ ({LIB_NAME})")
            _publish(tmp, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_client(name: str) -> Path:
    """A C client (``test_shim`` or ``scene_client``) beside the library
    it links, found at run time through its rpath ($ORIGIN)."""
    if name not in CLIENTS:
        raise ValueError(f"unknown client {name!r}: {CLIENTS}")
    lib = build_shim()
    exe = lib.parent / name
    with _lock:
        if exe.exists():
            return exe
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", dir=lib.parent)
        os.close(fd)
        try:
            _run([_compiler("gcc"), "-O2", "-Wall", "-o", tmp,
                  str(SRC_DIR / f"{name}.c"), f"-L{lib.parent}",
                  "-lopenal_torch", "-lm", "-Wl,-rpath,$ORIGIN"],
                 f"gcc ({name}.c)")
            _publish(Path(tmp), exe)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return exe


def client_env(device: str = "cuda", **extra: str) -> dict:
    """The environment of a C client: this interpreter's import path for
    the embedded one (so it finds torch and numpy wherever they are
    installed) and ``OPENAL_TORCH_DEVICE``."""
    paths = [p for p in sys.path if p and os.path.isdir(p)]
    env = dict(os.environ, OPENAL_TORCH_DEVICE=str(device),
               PYTHONPATH=os.pathsep.join(paths))
    env.update(extra)
    return env


def main() -> None:
    print(build_limiter())
    for name in CLIENTS:
        print(build_client(name))
    print(build_shim())


if __name__ == "__main__":
    main()
