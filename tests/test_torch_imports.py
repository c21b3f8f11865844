"""The port imports and renders without JAX."""

import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "openal_soft_tpu_torch"
ROOT = PKG.parent


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


_BLOCKED = r"""
import importlib, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
for name in sys.argv[1:]:
    importlib.import_module(name)
# Render a small HRTF scene: the shared host modules read the config at
# run time, which must not reach the JAX render path either.
import numpy as np
from openal_soft_tpu_torch.alc.device import LoopbackDevice
dev = LoopbackDevice(capacity=4, hrtf=True)
ctx = dev.create_context()
buf = ctx.create_buffer()
buf.set_data((0.3 * np.sin(np.arange(4800) * 0.05)).astype(np.float32),
             "mono", "float32", 48000)
src = ctx.create_source()
src.buffer(buf)
src.looping = True
src.set("position", (1.0, 0.0, -1.0))
src.play()
out = dev.render_samples(2048)
assert out.shape == (2048, 2) and np.isfinite(out).all() and out.any()
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert loaded == ["jax"], loaded          # only the blocking None entry
print("ok")
"""


def test_every_port_module_imports_and_renders_with_jax_blocked():
    mods = _port_modules()
    assert "openal_soft_tpu_torch.core.device" in mods
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


_INSTALLED = r"""
import sys
import numpy as np
import openal_soft_tpu_torch
from openal_soft_tpu_torch.alc.device import LoopbackDevice
dev = LoopbackDevice(capacity=4, hrtf=True)
ctx = dev.create_context()
buf = ctx.create_buffer()
buf.set_data((0.3 * np.sin(np.arange(4800) * 0.05)).astype(np.float32),
             "mono", "float32", 48000)
src = ctx.create_source()
src.buffer(buf)
src.looping = True
src.play()
assert dev.render_samples(2048).any()
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
# The reference package still resolves through its lazily loaded alc.
import openal_soft_tpu.alc as alc
from openal_soft_tpu.alc import config, LoopbackDevice as JaxLoopback
assert JaxLoopback.__module__ == "openal_soft_tpu.alc.device"
assert alc.context.Context is alc.Context
print("ok")
"""


def test_port_render_leaves_jax_unimported_where_jax_is_installed():
    res = subprocess.run([sys.executable, "-c", _INSTALLED],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
