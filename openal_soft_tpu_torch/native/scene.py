"""Scene files for the C scene client (``scene_client.c``), and its run.

``write_scene`` lays a voice scene out as the client reads it: the tone
pool's PCM, each voice's tone, position and pitch, and the render calls'
sizes.  ``run_scene_client`` builds the client, runs it on a torch device
and returns the frames it rendered with its own wall times.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

import numpy as np

MAGIC = b"ALSCENE1"
VOICE = np.dtype([("tone", "<i4"), ("has_pitch", "<i4"), ("x", "<f8"),
                  ("y", "<f8"), ("z", "<f8"), ("pitch", "<f8")])


def write_scene(path: str, rate: int, hrtf: bool, tones: list[np.ndarray],
                tone_of_voice, positions, pitches, frames: int,
                calls: int) -> None:
    """``tones``: equal-length mono float32 arrays; ``tone_of_voice`` [V]
    indices into them; ``positions`` [V, 3] float64; ``pitches`` [V]
    float64 or None (no AL_PITCH call)."""
    pcm = np.stack([np.asarray(t, np.float32) for t in tones])
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    voices = np.zeros(pos.shape[0], VOICE)
    voices["tone"] = np.asarray(tone_of_voice)
    voices["x"], voices["y"], voices["z"] = pos.T
    if pitches is not None:
        voices["has_pitch"] = 1
        voices["pitch"] = np.asarray(pitches, np.float64)
    hdr = np.array([rate, int(hrtf), pcm.shape[0], pcm.shape[1],
                    pos.shape[0], frames, calls], "<i4")
    with open(path, "wb") as fh:
        fh.write(MAGIC + hdr.tobytes() + pcm.astype("<f4").tobytes()
                 + voices.tobytes())


def run_scene_client(scene_path: str, device: str = "cuda",
                     timeout: float = 900.0, **env) -> dict:
    """Run scene_client on ``device``.  Returns {"frames": [calls * frames,
    2] float32, "build_s", "render_s": [per call], "wall_s", "stdout"};
    raises with the client's output if it fails."""
    from . import build

    exe = build.build_client("scene_client")
    with open(scene_path, "rb") as fh:
        hdr = np.frombuffer(fh.read(len(MAGIC) + 28)[len(MAGIC):], "<i4")
    frames, calls = int(hdr[5]), int(hdr[6])
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "frames.f32")
        t0 = time.perf_counter()
        res = subprocess.run([str(exe), scene_path, out],
                             capture_output=True, text=True, timeout=timeout,
                             env=build.client_env(device, **env))
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"scene_client exited {res.returncode}:\n"
                               f"{res.stdout}{res.stderr[-4000:]}")
        data = np.fromfile(out, "<f4").reshape(calls * frames, 2)
    vals = [ln.split("=", 1) for ln in res.stdout.splitlines() if "=" in ln]
    return {"frames": data,
            "build_s": float(next(v for k, v in vals if k == "BUILD_S")),
            "render_s": [float(v) for k, v in vals if k == "RENDER_S"],
            "wall_s": wall, "stdout": res.stdout}
