"""The port imports and renders without JAX and without the JAX package."""

import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "openal_soft_tpu_torch"
ROOT = PKG.parent
REFERENCE_IMPORT = re.compile(
    r"^\s*(from|import)\s+openal_soft_tpu(\.|\s|$)", re.MULTILINE)


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


# A small scene with the loaded shape: pitched HRTF voices sending to one
# EAXReverb slot, rendered on the CPU through the fused and per-block paths.
_SCENE = r"""
import numpy as np
from openal_soft_tpu_torch.alc.device import LoopbackDevice
dev = LoopbackDevice(capacity=4, hrtf=True, device="cpu")
ctx = dev.create_context()
slot = ctx.create_aux_slot()
slot.set_effect(ctx.create_effect("eaxreverb"))
buf = ctx.create_buffer()
buf.set_data((0.3 * np.sin(np.arange(4800) * 0.05)).astype(np.float32),
             "mono", "float32", 48000)
for pitch in (0.7, 1.6):
    src = ctx.create_source()
    src.buffer(buf)
    src.looping = True
    src.set("position", (1.0, 0.0, -1.0))
    src.set("pitch", pitch)
    src.send(slot, 0)
    src.play()
out = np.concatenate([dev.render_samples(4096), dev.render_samples(1024)])
assert out.shape == (5120, 2) and np.isfinite(out).all() and out.any()
# A surround51 scene with an echo and a dedicated-dialog slot (the real
# output), one voice sending to each.
fx = LoopbackDevice(channels="surround51", hrtf=False, capacity=4,
                    device="cpu")
fctx = fx.create_context()
fbuf = fctx.create_buffer()
fbuf.set_data((0.3 * np.sin(np.arange(4800) * 0.05)).astype(np.float32),
              "mono", "float32", 48000)
for name in ("echo", "dedicated_dialog"):
    fslot = fctx.create_aux_slot()
    fslot.set_effect(fctx.create_effect(name))
    src = fctx.create_source()
    src.buffer(fbuf)
    src.looping = True
    src.send(fslot, 0)
    src.play()
out = fx.render_samples(2048)
assert out.shape == (2048, 6) and np.isfinite(out).all() and out[:, 2].any()
# A filtered speaker scene: stereo pairwise output, a lowpass direct filter
# and a lowpass send filter into the slot.
spk = LoopbackDevice(capacity=4, device="cpu")
sctx = spk.create_context()
sslot = sctx.create_aux_slot()
sslot.set_effect(sctx.create_effect("eaxreverb"))
sbuf = sctx.create_buffer()
sbuf.set_data((0.3 * np.sin(np.arange(4800) * 0.05)).astype(np.float32),
              "mono", "float32", 48000)
flt = sctx.create_filter("lowpass")
flt.set("gain_hf", 0.4)
src = sctx.create_source()
src.buffer(sbuf)
src.looping = True
src.set("position", (1.0, 0.0, -1.0))
src.set("pitch", 1.3)
src.direct_filter(flt)
src.send(sslot, 0, flt)
src.play()
out = spk.render_samples(2048)
assert "gate:nofilt" not in spk._graph_gates()
assert out.shape == (2048, 2) and np.isfinite(out).all() and out.any()
# The filtered scene through the AL/ALC entry points, then a null playback
# device that renders on its own thread until it is closed.
import time
from openal_soft_tpu_torch.al import api as al
adev = al.alcLoopbackOpenDeviceSOFT(48000, "stereo", "float32", capacity=4,
                                    device="cpu")
al.alcMakeContextCurrent(al.alcCreateContext(adev))
abuf = al.alGenBuffers()
al.alBufferData(abuf, al.AL_FORMAT_MONO_FLOAT32,
                (0.3 * np.sin(np.arange(4800) * 0.05)).astype(np.float32),
                48000)
aslot, aeff, aflt = (al.alGenAuxiliaryEffectSlots(), al.alGenEffects(),
                     al.alGenFilters())
al.alEffecti(aeff, al.AL_EFFECT_TYPE, 0x8000)            # EAXReverb
al.alAuxiliaryEffectSloti(aslot, al.AL_EFFECTSLOT_EFFECT, aeff)
al.alFilteri(aflt, al.AL_FILTER_TYPE, 1)                 # lowpass
al.alFilterf(aflt, 2, 0.4)                               # gain_hf
asrc = al.alGenSources()
al.alSourcei(asrc, al.AL_BUFFER, abuf)
al.alSourcei(asrc, al.AL_LOOPING, al.AL_TRUE)
al.alSourcei(asrc, al.AL_DIRECT_FILTER, aflt)
al.alSource3f(asrc, al.AL_POSITION, 1.0, 0.0, -1.0)
al.alSourcef(asrc, al.AL_PITCH, 1.3)
al.alSource3i(asrc, al.AL_AUXILIARY_SEND_FILTER, aslot, 0, aflt)
al.alSourcePlay(asrc)
out = al.alcRenderSamplesSOFT(adev, 2048)
assert al.alGetError() == al.AL_NO_ERROR
assert out.shape == (2048, 2) and np.isfinite(out).all() and out.any()
pdev = al.alcOpenDevice("Null Output", capacity=4, device="cpu")
al.alcMakeContextCurrent(al.alcCreateContext(pdev))
deadline = time.time() + 30
while pdev.backend.frames_rendered == 0 and time.time() < deadline:
    time.sleep(0.01)
assert pdev.backend.frames_rendered > 0
al.alcCloseDevice(pdev)
"""

_BLOCKED = r"""
import importlib, sys
sys.modules["jax"] = None              # any `import jax` now raises
sys.modules["openal_soft_tpu"] = None  # and so does the JAX package
for name in sys.argv[1:]:
    importlib.import_module(name)
""" + _SCENE + r"""
loaded = sorted(m for m in sys.modules
                if m in ("jax", "openal_soft_tpu")
                or m.startswith(("jax.", "jaxlib", "openal_soft_tpu.")))
assert loaded == ["jax", "openal_soft_tpu"], loaded   # the blocking entries
print("ok")
"""


def test_every_port_module_imports_and_renders_with_jax_blocked():
    mods = _port_modules()
    assert "openal_soft_tpu_torch.core.device" in mods
    assert "openal_soft_tpu_torch.effects.reverb" in mods
    assert "openal_soft_tpu_torch.al.api" in mods
    assert "openal_soft_tpu_torch.alc.lifecycle" in mods
    for name in ("utils.uhjencoder", "utils.uhjdecoder", "utils.makemhr",
                 "utils.sofa_info", "utils.openal_info", "native.build",
                 "native.scene", "native.gen_shim", "examples.alreverb",
                 "examples.aldirect", "parallel", "parallel.sharding"):
        assert f"openal_soft_tpu_torch.{name}" in mods
    res = subprocess.run([sys.executable, "-c", _BLOCKED, *mods],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+jax\b", re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    offenders += [name for name in ("chip_smoke.py",)
                  if pat.search((ROOT / name).read_text())]
    assert offenders == []


def test_port_sources_never_import_the_jax_package():
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if REFERENCE_IMPORT.search(p.read_text())]
    offenders += [name for name in ("chip_smoke.py",)
                  if REFERENCE_IMPORT.search((ROOT / name).read_text())]
    assert offenders == []
    # The pattern does catch such a line.
    assert REFERENCE_IMPORT.search("from openal_soft_tpu.core import hrtf")
    assert REFERENCE_IMPORT.search("  import openal_soft_tpu")
    assert not REFERENCE_IMPORT.search("import openal_soft_tpu_torch")


_INSTALLED = r"""
import sys
import openal_soft_tpu_torch
""" + _SCENE + r"""
assert not [m for m in sys.modules
            if m in ("jax", "openal_soft_tpu")
            or m.startswith(("jax.", "openal_soft_tpu."))]
print("ok")
"""


def test_port_render_leaves_jax_unimported_where_jax_is_installed():
    res = subprocess.run([sys.executable, "-c", _INSTALLED],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
