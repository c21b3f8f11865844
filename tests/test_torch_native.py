"""The port's C ABI (libopenal_torch.so) and its native limiter, on the CPU.

The library embeds CPython over openal_soft_tpu_torch.al.api; C clients
select the torch device with OPENAL_TORCH_DEVICE.  Here: the C smoke client
on the CPU, the export surface, a 16-voice scene built by the C program
scene_client bit-equal to the same scene built through al.api, the card's
device failing to open on a machine without one, and no trace of JAX or
the JAX package in the library or the embedded interpreter.  Skips only
without a C/C++ toolchain, as tests/test_native_shim.py does.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "openal_soft_tpu_torch"
RATE = 48000
N_TONES = 8

needs_toolchain = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="no C/C++ toolchain")


@pytest.fixture(scope="module")
def native():
    from openal_soft_tpu_torch.native import build

    for name in build.CLIENTS:
        build.build_client(name)
    return build


@pytest.fixture(scope="module")
def fake_alsa(tmp_path_factory):
    lib = tmp_path_factory.mktemp("alsa") / "libfakeasound.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", str(lib),
                    str(ROOT / "tests" / "fake_alsa.c")], check=True)
    return str(lib)


@needs_toolchain
def test_c_smoke_client_on_the_cpu(native, fake_alsa):
    proc = subprocess.run(
        [str(native.build_client("test_shim"))], capture_output=True,
        text=True, timeout=600,
        env=native.client_env("cpu", OPENAL_TPU_ALSA_LIB=fake_alsa))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    for marker in ("PEAK=", "STREAM_PEAK=", "CAPTURED=", "EAX_DECAY="):
        assert marker in proc.stdout, (marker, proc.stdout)


REQUIRED = ("alcCaptureOpenDevice", "alcCaptureSamples", "alGetSourcefv",
            "alGetListener3f", "alSourceivDirect", "alGetSourceiDirect",
            "EAXSet", "EAXGet", "alEAXSetBufferMode", "alMapBufferSOFT",
            "alBufferSubDataSOFT", "alEventCallbackSOFT",
            "alDebugMessageCallbackEXT", "alGetStringiSOFT",
            "alcLoopbackOpenDeviceSOFT", "alcRenderSamplesSOFT",
            "alSource3dSOFT", "alSourcedSOFT")


@needs_toolchain
def test_export_surface(native):
    out = subprocess.run(["nm", "-D", "--defined-only",
                          str(native.build_shim())],
                         capture_output=True, text=True, check=True).stdout
    syms = {line.split()[-1] for line in out.splitlines() if " T " in line}
    assert len({s for s in syms if s.startswith(("al", "EAX"))}) >= 250
    missing = [name for name in REQUIRED if name not in syms]
    assert missing == []


def _scene(n_voices: int, pitched: bool):
    """Seeded tones, positions (and pitches): api_scene's draw order."""
    t = np.arange(RATE) / RATE
    tones = [(0.1 * np.sin(2 * np.pi * 110.0 * 2.0 ** (fi / 12.0) * t)
              ).astype(np.float32) for fi in range(N_TONES)]
    rng = np.random.default_rng(42)
    pos, pitch = [], []
    for _ in range(n_voices):
        pos.append(rng.standard_normal(3) * 3.0)
        pitch.append(float(2.0 ** rng.uniform(-1, 1)))
    return tones, np.array(pos), (np.array(pitch) if pitched else None)


def _api_render(tones, pos, pitch, frames: int, calls: int) -> np.ndarray:
    from openal_soft_tpu_torch.al import api as al

    dev = al.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32", hrtf=True,
                                       capacity=len(pos), device="cpu")
    al.alcMakeContextCurrent(al.alcCreateContext(dev))
    bufs = []
    for tone in tones:
        bid = al.alGenBuffers()
        al.alBufferData(bid, al.AL_FORMAT_MONO_FLOAT32, tone, RATE)
        bufs.append(bid)
    for i, p in enumerate(pos):
        sid = al.alGenSources()
        al.alSourcei(sid, al.AL_BUFFER, bufs[i % len(bufs)])
        al.alSourcei(sid, al.AL_LOOPING, al.AL_TRUE)
        al.alSource3f(sid, al.AL_POSITION, *p)
        if pitch is not None:
            al.alSourcef(sid, al.AL_PITCH, pitch[i])
        al.alSourcePlay(sid)
    out = np.concatenate([al.alcRenderSamplesSOFT(dev, frames)
                          for _ in range(calls)])
    assert al.alGetError() == al.AL_NO_ERROR
    al.alcMakeContextCurrent(None)
    return out


@needs_toolchain
@pytest.mark.parametrize("pitched", [False, True])
def test_scene_client_matches_the_python_api(native, tmp_path, pitched):
    """16 voices built by the C program: bit-equal to al.api's build of
    the same scene, both on the CPU."""
    from openal_soft_tpu_torch.native import scene

    tones, pos, pitch = _scene(16, pitched)
    path = str(tmp_path / "s.scene")
    scene.write_scene(path, RATE, True, tones, np.arange(16) % N_TONES, pos,
                      pitch, 2048, 2)
    got = scene.run_scene_client(path, "cpu", timeout=600)
    want = _api_render(tones, pos, pitch, 2048, 2)
    assert got["frames"].shape == (4096, 2) and len(got["render_s"]) == 2
    assert np.isfinite(got["frames"]).all() and np.abs(want).max() > 0.01
    np.testing.assert_array_equal(got["frames"], want)


@needs_toolchain
def test_the_card_does_not_open_without_one(native, tmp_path):
    """OPENAL_TORCH_DEVICE=cuda (the default) on a machine without a card:
    the open returns NULL with the Python error printed, and the client
    renders nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from openal_soft_tpu_torch.native import scene

    tones, pos, _ = _scene(2, False)
    path = str(tmp_path / "s.scene")
    out = str(tmp_path / "frames.f32")
    scene.write_scene(path, RATE, True, tones, [0, 1], pos, None, 256, 1)
    env = native.client_env("cuda")
    proc = subprocess.run([str(native.build_client("scene_client")), path,
                           out], capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 1
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "alcLoopbackOpenDeviceSOFT failed" in proc.stderr
    assert not os.path.exists(out)
    env.pop("OPENAL_TORCH_DEVICE")
    proc = subprocess.run([str(native.build_client("scene_client")), path,
                           out], capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 1 and "is_available() is False" in proc.stderr


_EMBEDDED = r"""
import ctypes as ct, os, sys
import numpy as np
os.environ["OPENAL_TORCH_DEVICE"] = "cpu"
from openal_soft_tpu_torch.native import build
lib = ct.CDLL(str(build.build_shim()))
lib.alcLoopbackOpenDeviceSOFT.restype = ct.c_void_p
lib.alcCreateContext.restype = ct.c_void_p
lib.alcCreateContext.argtypes = [ct.c_void_p, ct.c_void_p]
lib.alcMakeContextCurrent.argtypes = [ct.c_void_p]
dev = lib.alcLoopbackOpenDeviceSOFT(None)
lib.alcMakeContextCurrent(lib.alcCreateContext(dev, None))
tone = (0.3 * np.sin(np.arange(4800) * 0.05)).astype(np.float32)
b, s = ct.c_uint(), ct.c_uint()
lib.alGenBuffers(1, ct.byref(b))
lib.alBufferData(b, 0x10010, tone.ctypes.data_as(ct.c_void_p), tone.nbytes,
                 48000)
lib.alGenSources(1, ct.byref(s))
lib.alSourcei(s, 0x1009, b.value)
lib.alSourcePlay(s)
out = np.zeros((1024, 2), np.float32)
lib.alcRenderSamplesSOFT(ct.c_void_p(dev), out.ctypes.data_as(ct.c_void_p),
                         1024)
assert np.abs(out).max() > 0.01
print(sorted(m for m in sys.modules if m in ("jax", "openal_soft_tpu")
             or m.startswith(("jax.", "jaxlib", "openal_soft_tpu."))))
"""


@needs_toolchain
def test_the_c_abi_never_loads_jax(native):
    lib = native.build_shim()
    blob = lib.read_bytes()
    assert b"openal_soft_tpu_torch.al.api" in blob
    assert b"openal_soft_tpu.al.api" not in blob
    ldd = subprocess.run(["ldd", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    assert "libopenal_tpu" not in ldd and "libpython" in ldd
    res = subprocess.run([sys.executable, "-c", _EMBEDDED],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


# --- the output limiter ------------------------------------------------------

_LIMITER_ALONE = r"""
from openal_soft_tpu_torch.core import mastering
lim = mastering.Limiter(2, 48000.0, -0.1)
assert lim._lib is not None
print(lim._lib._name)
"""


@needs_toolchain
def test_limiter_builds_from_the_ports_own_source(tmp_path):
    """A copy of the package with no repository around it (no native/ of
    the JAX package beside it) builds and loads its limiter."""
    copy = tmp_path / "openal_soft_tpu_torch"
    shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    res = subprocess.run([sys.executable, "-c", _LIMITER_ALONE],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert res.returncode == 0, res.stderr[-3000:]
    built = Path(res.stdout.strip())
    assert built.parent == copy / "_build" and built.exists()
    assert not (tmp_path / "native").exists()


@needs_toolchain
def test_limiter_matches_its_python_oracle():
    from openal_soft_tpu_torch.core import mastering

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4096, 2)) * 0.9).astype(np.float32)
    a, b = x.copy(), x.copy()
    nat = mastering.Limiter(2, 48000.0, -0.1)
    assert nat._lib is not None
    py = mastering._PyLimiter(2, 48000.0, -0.1)
    for i in range(0, 4096, 1024):
        nat.process(a[i:i + 1024])
        py.process(b[i:i + 1024])
    # float32 gain recurrence against the oracle's float64 (the JAX
    # package's bound, tests/test_output_stage.py).
    assert np.abs(a - b).max() < 2e-3 and np.abs(a - x).max() > 0.01


@needs_toolchain
def test_a_failed_limiter_build_raises(monkeypatch):
    """With g++ present, a build that fails raises with the compiler's
    output; the Python limiter does not stand in."""
    from openal_soft_tpu_torch.core import mastering
    from openal_soft_tpu_torch.native import build

    def broken():
        raise RuntimeError("g++ (limiter.cpp) failed (exit 1): error: ...")

    monkeypatch.setattr(build, "build_limiter", broken)
    monkeypatch.setattr(mastering, "_LIB", None)
    monkeypatch.setattr(mastering, "_LIB_TRIED", False)
    with pytest.raises(RuntimeError, match="limiter.cpp"):
        mastering.Limiter(2, 48000.0, -0.1)
