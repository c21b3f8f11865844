"""The port's 14 example programs on the CPU, three against the JAX ones.

Every example runs as ``python -m openal_soft_tpu_torch.examples.<name>
--device cpu`` with <= 0.5 s of audio and seeded inputs, exits 0 and
writes a nonzero WAV where it writes one.  altonegen, alhrtf and alloopback
render unfiltered scenes with no slot; their rendered frames (taken before
the WAV's int16 rounding) match the JAX examples' for the same arguments
within 1e-5.  The others only run: they carry slots, filters, capture or
streaming paths whose JAX renders on XLA:CPU are slow or not references
(ROADMAP C5), and aldirect drives the C library.
"""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest

# The JAX examples render after host changes (alhrtf moves its source every
# 2400 frames): their renders read private copies of the host tables.
from tests.test_torch_api import jax_renders_from_private_copies  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 0.5
RATE = 48000
JAX_TOL = 1e-5

EXAMPLES = ("altonegen", "alhrtf", "alplay", "aldirect", "alconvolve",
            "aldebug", "allafplay", "allatency", "alloopback",
            "almultireverb", "alrecord", "alreverb", "alstream",
            "alstreamcb")


def _inputs(d: str) -> None:
    from openal_soft_tpu_torch.examples.allafplay import write_laf
    from openal_soft_tpu_torch.examples.altonegen import _write_wav

    rng = np.random.default_rng(33)
    t = np.arange(int(SECONDS * RATE)) / RATE
    _write_wav(os.path.join(d, "in.wav"), np.stack(
        [0.3 * np.sin(2 * np.pi * 330 * t),
         0.2 * rng.standard_normal(t.size)], 1).astype(np.float32), RATE)
    write_laf(os.path.join(d, "in.laf"),
              (0.2 * rng.standard_normal((3, t.size))).astype(np.float32),
              RATE, [(0.0, 30.0, 0), (0.0, -30.0, 0), (0.0, 0.0, 1)])


def _args(name: str, d: str) -> list[str]:
    out, s = os.path.join(d, "out.wav"), str(SECONDS)
    return {"altonegen": ["-s", s, "-o", out], "alhrtf": ["-s", s, "-o", out],
            "alplay": [os.path.join(d, "in.wav"), "-o", out],
            "aldirect": ["--name", "Null Output"],
            "alconvolve": ["-s", s, "-o", out], "aldebug": [],
            "allafplay": [os.path.join(d, "in.laf"), "-o", out],
            "allatency": ["--seconds", s],
            "alloopback": ["-s", s, "-o", out],
            "almultireverb": ["--seconds", s, "-o", out],
            "alrecord": ["-s", s, "-o", out],
            "alreverb": ["-s", s, "-o", out],
            "alstream": [os.path.join(d, "in.wav"), "-o", out],
            "alstreamcb": ["--seconds", s, "-o", out]}[name]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(tmp_path, name):
    d = str(tmp_path)
    _inputs(d)
    args = _args(name, d)
    res = subprocess.run(
        [sys.executable, "-m", f"openal_soft_tpu_torch.examples.{name}",
         *args, "--device", "cpu"], capture_output=True, text=True,
        cwd=ROOT, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert res.stdout.strip()
    if "-o" in args:
        with wave.open(args[args.index("-o") + 1], "rb") as fh:
            frames = fh.getnframes()
            pcm = np.frombuffer(fh.readframes(frames), "<i2")
        assert frames >= int(0.9 * SECONDS * min(RATE, 44100))
        assert np.abs(pcm).max() > 0


def _capture(monkeypatch, module) -> list:
    """Replace the module's WAV writer; the list receives its frames."""
    got = []
    monkeypatch.setattr(module, "_write_wav",
                        lambda path, data, rate: got.append(
                            np.array(data, np.float32)))
    return got


# alloopback has no length option in the JAX package: 2 s on both sides.
COMPARED = {"altonegen": ["-s", str(SECONDS), "-t", "square"],
            "alhrtf": ["-s", str(SECONDS)],
            "alloopback": ["-s", "2"]}


@pytest.mark.parametrize("name", sorted(COMPARED))
def test_example_matches_jax(tmp_path, monkeypatch, name):
    import importlib

    args = COMPARED[name] + ["-o", str(tmp_path / "out.wav")]
    port = importlib.import_module(f"openal_soft_tpu_torch.examples.{name}")
    got = _capture(monkeypatch, port)
    port.main(args + ["--device", "cpu"])

    monkeypatch.syspath_prepend(ROOT)
    ref = importlib.import_module(f"examples.{name}")
    want = _capture(monkeypatch, ref)
    jax_args = [a for a in args if name != "alloopback"
                or a not in ("-s", "2")]
    monkeypatch.setattr(sys, "argv", [name, *jax_args])
    ref.main()
    assert len(got) == len(want) == 1
    a, b = got[0], want[0]
    assert a.shape == b.shape and np.abs(b).max() > 0.05
    assert np.isfinite(a).all()
    assert np.abs(a - b).max() <= JAX_TOL
