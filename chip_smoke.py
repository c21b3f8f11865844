#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openal_soft_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and prints
no result:

  1. env      the card (nvidia-smi name and power limit), torch and CUDA
  2. build    nvcc builds every kernel of the path from csrc/
  3. kernel   each kernel against its plain torch version on the card, on
              voices with loop seams, backward wraps, end clamps, pre-start
              silence and empty sources: bit-equal required
  4. timing   kernel and plain version at the main path's shape (CUDA
              events, 20 launches after warm-up)
  5. best_case  the bench scene at full width: 4096 looping HRTF voices,
              48 one-second tones, 512 blocks of 1024 frames per call;
              the kernel's launch count is reset just before the timed call
              and must grow; the output must be finite and nonzero
  6. parity   the same scene at 64 voices on the card and on the CPU: the
              fused super-block path (8192 frames), the per-block path
              (4096 frames) and odd sizes, max |diff| <= 1e-5

Then the kernels' JSON line, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero at once when
torch.cuda.is_available() is false.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

RATE = 48000
BLOCK = 1024
CHUNK_BLOCKS = 512
N_VOICES = 4096
N_TONES = 48
PARITY_TOL = 1e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def tone_pool(n_tones: int) -> list[np.ndarray]:
    t = np.arange(RATE) / RATE
    return [(0.1 * np.sin(2 * np.pi * 110.0 * 2.0 ** (fi / 12.0) * t)
             ).astype(np.float32) for fi in range(n_tones)]


def best_case_scene(n_voices: int, capacity: int, device: str):
    """bench.py's best_case scene on the port (seed 42, positions x3.0)."""
    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    dev = LoopbackDevice(frequency=RATE, channels="stereo",
                         sample_type="float32", capacity=capacity,
                         hrtf=True, device=device)
    ctx = dev.create_context()
    rng = np.random.default_rng(42)
    bufs = []
    for tone in tone_pool(N_TONES):
        buf = ctx.create_buffer()
        buf.set_data(tone, "mono", "float32", RATE)
        bufs.append(buf)
    for i in range(n_voices):
        src = ctx.create_source()
        src.buffer(bufs[i % N_TONES])
        src.looping = True
        src.set("position", tuple(rng.standard_normal(3) * 3.0))
        src.play()
    return dev


def unit_case(rng, V: int, W: int, taps: int, device):
    """Inputs for the unit kernel covering every resolve branch: loop seam
    inside the window, short loops (several seams), backward wrap of the
    history, non-looping end clamp, pre-start silence, empty sources."""
    import torch

    lens = rng.integers(W // 2 + 64, 3 * W + 4096, V)
    pool_len = int(lens.sum()) + 4096
    pool = rng.standard_normal(pool_len).astype(np.float32)
    off = np.concatenate([[8], 8 + np.cumsum(lens[:-1])])
    ls = rng.integers(0, lens // 4)
    le = ls + rng.integers(1, lens - ls + 1)
    has_loop = np.zeros(V, bool)
    has_wrapped = np.zeros(V, bool)
    pos = rng.integers(0, lens)
    kind = np.arange(V) % 8
    seam = kind == 0                  # loop seam inside the window
    has_loop[seam] = True
    pos[seam] = np.maximum(le[seam] - W // 2, ls[seam])
    short = kind == 1                 # loops shorter than the window
    has_loop[short] = True
    le[short] = ls[short] + rng.integers(1, max(W // 4, 2), short.sum())
    pos[short] = ls[short]
    back = kind == 2                  # wrapped: history wraps backward
    has_loop[back] = has_wrapped[back] = True
    pos[back] = ls[back] + rng.integers(0, taps + 1, back.sum())
    clamp = kind == 3                 # non-looping end clamp
    pos[clamp] = lens[clamp] - W // 3
    pre = kind == 4                   # delayed start: silence before 0
    pos[pre] = -rng.integers(1, W // 2 + taps + 2, pre.sum())
    empty = kind == 5                 # src_len == 0
    lens[empty] = 0
    has_loop[kind == 6] = True        # looping, seam outside the window
    T = lambda a, dt=torch.int32: torch.tensor(np.asarray(a), device=device
                                               ).to(dt)
    w = rng.standard_normal((V, taps)).astype(np.float32)
    return (T(pool, torch.float32), T(off), T(lens), T(ls), T(le),
            T(has_loop, torch.bool), T(has_wrapped, torch.bool), T(pos),
            T(w, torch.float32))


def cuda_ms(fn, iters: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from openal_soft_tpu_torch.ops.kernels import _build
    from openal_soft_tpu_torch.ops.kernels import resample_unit as rs_unit

    cuda = torch.device("cuda", 0)
    smi = nvidia_smi()

    # 1. environment
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build
    t0 = time.perf_counter()
    so = _build.build("resample_unit")
    rs_unit._launcher()
    emit({"phase": "build", "kernel": "resample_unit", "library": so.name,
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in
                    _build.build_logs.get("resample_unit", "").splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernel against its plain version on the card
    rng = np.random.default_rng(0)
    max_err = 0.0
    for taps in (4, 24, 48):
        for W in (128, 1024, 16384):
            args = unit_case(rng, 256, W, taps, cuda)
            got = rs_unit.resample_unit(*args, W)
            want = rs_unit.resample_unit_ref(*args, W)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            equal = bool(torch.equal(got, want))
            emit({"phase": "kernel", "name": "resample_unit", "V": 256,
                  "W": W, "taps": taps, "max_abs_err": err,
                  "bit_equal": equal})
            if not equal:
                raise AssertionError(f"resample_unit != plain at W={W} "
                                     f"taps={taps}: max |diff| {err}")
            max_err = max(max_err, err)

    # 4. timing at the main path's shape: V=4096, W=16*1024, taps=4, on
    # best_case-like voices (48 looping one-second tones)
    V, W, taps = N_VOICES, 16 * BLOCK, 4
    lens = np.full(V, RATE)
    pool = np.concatenate([np.zeros(8, np.float32), *tone_pool(N_TONES),
                           np.zeros(4096, np.float32)])
    Ti = lambda a: torch.tensor(np.asarray(a), device=cuda).to(torch.int32)
    args = (torch.tensor(pool, device=cuda),
            Ti(8 + (np.arange(V) % N_TONES) * RATE), Ti(lens),
            Ti(np.zeros(V)), Ti(lens),
            torch.ones(V, dtype=torch.bool, device=cuda),
            torch.tensor(rng.random(V) < 0.5, device=cuda),
            Ti(rng.integers(0, RATE, V)),
            torch.tensor(rng.standard_normal((V, taps)).astype(np.float32),
                         device=cuda))
    got = rs_unit.resample_unit(*args, W)
    want = rs_unit.resample_unit_ref(*args, W)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"resample_unit != plain at the main shape: "
                             f"max |diff| {err}")
    max_err = max(max_err, err)
    del got, want
    ms = cuda_ms(lambda: rs_unit.resample_unit(*args, W), 20, 3)
    plain_ms = cuda_ms(lambda: rs_unit.resample_unit_ref(*args, W), 20, 2)
    emit({"phase": "timing", "name": "resample_unit", "V": V, "W": W,
          "taps": taps, "ms": ms, "plain_ms": plain_ms,
          "write_GBps": V * W * 4 / (ms * 1e-3) / 1e9, "nvidia_smi": smi})
    del args

    # 5. best_case at full width through the port's entry points
    t0 = time.perf_counter()
    dev = best_case_scene(N_VOICES, N_VOICES, "cuda")
    setup_s = time.perf_counter() - t0
    frames = CHUNK_BLOCKS * BLOCK
    t0 = time.perf_counter()
    dev.render_samples(frames)                       # warm
    warm_s = time.perf_counter() - t0
    rs_unit.resample_unit.launches = 0
    t0 = time.perf_counter()
    out = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = rs_unit.resample_unit.launches
    realtime = (frames / RATE) / dt
    finite = bool(np.isfinite(out).all())
    peak = float(np.abs(out).max())
    emit({"phase": "best_case", "voices": N_VOICES, "frames": frames,
          "setup_s": setup_s, "warm_s": warm_s, "render_s": dt,
          "x_realtime": realtime, "launches": launches, "finite": finite,
          "peak": peak, "shape": list(out.shape), "nvidia_smi": smi})
    if out.shape != (frames, 2) or not finite or not peak > 0.0:
        raise AssertionError("best_case output is not finite, nonzero "
                             f"[{frames}, 2]: shape {out.shape}, "
                             f"finite {finite}, peak {peak}")
    if launches <= 0:
        raise AssertionError("best_case never launched resample_unit")
    del dev, out

    # 6. the port on the card against the port on the CPU
    g = best_case_scene(64, 64, "cuda")
    c = best_case_scene(64, 64, "cpu")
    for n, path in ((8192, "fused"), (4096, "per-block"), (100, "odd"),
                    (924, "odd"), (1, "odd")):
        a, b = g.render_samples(n), c.render_samples(n)
        err = float(np.abs(a - b).max())
        emit({"phase": "parity", "frames": n, "path": path,
              "max_abs_err": err, "tol": PARITY_TOL})
        if not (np.isfinite(a).all() and err <= PARITY_TOL):
            raise AssertionError(f"GPU vs CPU port at {n} frames: {err}")

    jax_loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if jax_loaded:
        raise AssertionError(f"the port imported JAX: {jax_loaded[:3]}")

    emit({"kernels": [{
        "name": "resample_unit", "route": "cuda",
        "source": "openal_soft_tpu_torch/csrc/resample_unit.cu",
        "replaces": "openal_soft_tpu/ops/pallas/resample_unit.py:284",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
