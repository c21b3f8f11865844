#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openal_soft_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero and prints no
result:

  1. env        the card (nvidia-smi name and power limit), torch and CUDA
  2. build      nvcc builds every kernel from csrc/, all at once, with each
                kernel's registers and spills (-Xptxas -v)
  3. kernel     resample_unit against its plain version on voices with loop
                seams, short loops, backward wraps, end clamps, pre-start
                silence and empty sources: bit-equal required
  4. timing     resample_unit and its plain version at the main path's shape
                (CUDA events)
  5. best_case  bench.py's best_case scene at full width: 4096 looping HRTF
                voices, 48 one-second tones, 512 blocks of 1024 frames per
                call; the output must be finite and nonzero
  6. parity     best_case at 64 voices on the card against the CPU: fused
                (8192 frames), per-block (4096) and odd sizes, <= 1e-5
  7. kernel     resample_gen against its plain version: every tier (taps 1,
                2, 4, 24, 48), increments 0.25x..10x, the same branch cases
                as phase 3: bit-equal required
  8. kernel     reverb against its plain version at 48 and 96 kHz, one
                pipeline and the A/B crossfade, windows of 1024 and 16384,
                >= 128 chunks each including the decaying tail: <= 1e-6
  9. timing     resample_gen and reverb and their plain versions at the
                loaded scene's shapes (CUDA events)
 10. loaded     bench.py's loaded scene at full width: 4096 voices at pitch
                2**U(-1,1), one EAXReverb slot on send 0, 512-block calls;
                the output must be finite and nonzero
 11. parity     loaded at 64 voices on the card against the CPU: fused
                (8192 frames), per-block (4096) and odd sizes, <= 1e-4

Every kernel's launch count is set to 0 just before its scene's timed call
and must have grown just after it.  Then the kernels' JSON line, the card's
nvidia-smi line, and last {"ok": true, "device": {...}}.  Exits non-zero at
once when torch.cuda.is_available() is false.

    python3 chip_smoke.py --profile best_case|loaded

instead builds the kernels and profiles one warm 512-block call of the
scene at full width with torch.profiler (device time by kernel and by op).
"""

from __future__ import annotations

import concurrent.futures
import copy
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
PARITY_TOL = 1e-5          # best_case: no feedback path
LOADED_TOL = 1e-4          # loaded: the reverb carries rounding forward
REVERB_TOL = 1e-6          # reverb kernel vs its plain version
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
KERNELS = ("resample_unit", "resample_gen", "reverb")


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


def bench_scene(n_voices: int, capacity: int, device: str,
                loaded: bool = False):
    """bench.py's scenes on the port (seed 42, positions x3.0, 48 tones):
    best_case, or loaded (pitch 2**U(-1,1), one EAXReverb slot, send 0)."""
    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    dev = LoopbackDevice(frequency=RATE, channels="stereo",
                         sample_type="float32", capacity=capacity,
                         hrtf=True, device=device)
    ctx = dev.create_context()
    slot = None
    if loaded:
        slot = ctx.create_aux_slot()
        slot.set_effect(ctx.create_effect("eaxreverb"))
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
        if loaded:
            src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
            src.send(slot, 0)
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


def gen_case(rng, V: int, W: int, taps: int, max_inc: int, device):
    """Inputs for the general kernel: unit_case's voices and branch cases
    at increments from 0.25x to max_inc (16.16), with random phases,
    resampler rows and scales, and the global weight bank."""
    import torch

    from openal_soft_tpu_torch.ops import tables

    (pool, off, lens, ls, le, has_loop, has_wrapped, pos,
     _) = unit_case(rng, V, W, taps, device)
    inc = rng.integers(1 << 14, max_inc + 1, V)
    # Keep (W-1)*inc + 65535 < 2**31 as the device's plan does.
    inc = np.minimum(inc, ((1 << 31) - 65536) // max(W - 1, 1))
    Ti = lambda a: torch.tensor(np.asarray(a), device=device).to(torch.int32)
    bank = {k: torch.tensor(v, device=device)
            for k, v in tables.weight_bank().items()}
    return (pool, off, lens, ls, le, has_loop, has_wrapped, pos,
            Ti(rng.integers(0, 1 << 16, V)), Ti(inc),
            Ti(rng.integers(0, 52, V)),
            torch.tensor(rng.random(V).astype(np.float32), device=device),
            bank)


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


def ptxas_lines(name: str) -> list[str]:
    from openal_soft_tpu_torch.ops.kernels import _build

    return [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln]


def build_all() -> None:
    """Phase 2: one nvcc per source, all started together."""
    from openal_soft_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    seconds = time.perf_counter() - t0
    for name in KERNELS:
        _build.load_library(name)
        emit({"phase": "build", "kernel": name, "library": libs[name].name,
              "seconds": seconds, "ptxas": ptxas_lines(name)})


def check_gen_kernel(cuda) -> float:
    """Phase 7: resample_gen bit-equal to its plain version."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen

    rng = np.random.default_rng(1)
    max_err = 0.0
    for taps in (1, 2, 4, 24, 48):
        for W, max_inc in ((128, 10 << 16), (1024, 10 << 16),
                           (16384, 1 << 17)):
            args = gen_case(rng, 256, W, taps, max_inc, cuda)
            got = rs_gen.resample_gen(*args, W, taps)
            want = rs_gen.resample_gen_ref(*args, W, taps)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            equal = bool(torch.equal(got, want))
            emit({"phase": "kernel", "name": "resample_gen", "V": 256,
                  "W": W, "taps": taps, "max_inc": max_inc,
                  "max_abs_err": err, "bit_equal": equal})
            if not equal:
                raise AssertionError(f"resample_gen != plain at W={W} "
                                     f"taps={taps}: max |diff| {err}")
            max_err = max(max_err, err)
    return max_err


def reverb_case(rate: int, crossfade: bool, device: str):
    """A device with one EAXReverb slot: (effect, device params, slot
    state).  Modulation is on so every stage runs; with ``crossfade`` a
    second full update leaves the old pipeline "B" fading."""
    import torch

    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    dev = LoopbackDevice(frequency=rate, hrtf=True, capacity=4,
                         device=device)
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("eaxreverb"))
    slot.set_props(modulation_depth=0.6, modulation_time=0.3)
    params = slot.compute_update()
    if crossfade:
        slot.set_props(decay_time=2.7, density=0.4, diffusion=0.7,
                       reflections_delay=0.05, late_reverb_delay=0.02)
        params = slot.compute_update()
    eff = slot.state
    prm = {k: torch.tensor(params[k], device=dev.torch_device)
           for k in eff.device_params if k in params}
    return eff, prm, dev._state["slot0"]


def run_reverb_windows(eff, prm, state, windows, kernel: bool) -> list:
    """Feed ``windows`` ([4, T] tensors) through every live pipeline with
    the kernel or the plain version; returns the outputs."""
    from openal_soft_tpu_torch.ops.kernels import reverb as rev_k

    fn = rev_k.reverb_pipeline if kernel else rev_k.reverb_pipeline_ref
    ctab = eff._tables(state["main"].device)["ctab"]
    pipes = [("A", "")] + ([("B", "old_")] if eff._old_active else [])
    outs = []
    for ain in windows:
        for n, (name, prefix) in enumerate(pipes):
            outs += fn(ain, state["main"], state[name], prm[prefix + "pi"],
                       prm[prefix + "pf"], state["offset"], ctab,
                       write_main=n == 0,
                       chunk=eff.chunk, e_passes=eff.early_ap_passes,
                       l_passes=eff.late_ap_passes, mod_win=eff.mod_win)
        state["offset"].add_(ain.shape[1])
    return outs


def reverb_windows(rng, T: int, chunk: int, device, min_chunks: int = 128):
    """Windows [4, T] covering >= min_chunks chunks: input in the first
    half, silence after (the decaying tail)."""
    import torch

    n = max(2, -(-min_chunks * chunk // T))
    return [torch.tensor((rng.standard_normal((4, T)) * 0.25).astype(
        np.float32) if k < n // 2 else np.zeros((4, T), np.float32),
        device=device) for k in range(n)]


def check_reverb_kernel(cuda) -> float:
    """Phase 8: the reverb kernel within REVERB_TOL of its plain version,
    outputs and carried state."""
    import torch

    rng = np.random.default_rng(2)
    max_err = 0.0
    for rate in (48000, 96000):
        for crossfade in (False, True):
            for T in (1024, 16384):
                eff, prm, st = reverb_case(rate, crossfade, "cuda")
                st_plain = copy.deepcopy(st)
                windows = reverb_windows(rng, T, eff.chunk, cuda)
                got = run_reverb_windows(eff, prm, st, windows, True)
                want = run_reverb_windows(eff, prm, st_plain, windows,
                                          False)
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                for name in ("A", "B"):
                    for k, v in st[name].items():
                        err = max(err, float((v.double() - st_plain[name][k]
                                              .double()).abs().max()))
                tail = float(max(o.abs().max() for o in got[-2:]))
                emit({"phase": "kernel", "name": "reverb", "rate": rate,
                      "crossfade": crossfade, "T": T,
                      "chunks": len(windows) * T // eff.chunk,
                      "max_abs_err": err, "tol": REVERB_TOL,
                      "tail_peak": tail,
                      "bit_equal": all(torch.equal(a, b)
                                       for a, b in zip(got, want))})
                if not err <= REVERB_TOL:
                    raise AssertionError(f"reverb != plain at {rate} Hz, "
                                         f"T={T}, crossfade={crossfade}: "
                                         f"{err}")
                max_err = max(max_err, err)
    return max_err


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it): the bytes over the HBM rate against the
    operations over the fp32 peak, whichever takes longer."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def resample_bound(V: int, W: int, taps: int, pool_len: int,
                   meta_cols: int, bank_floats: int) -> tuple[float, str]:
    """A resampler call: the output written once and every input read
    once, against ~8 flops per tap (weight, product, sum)."""
    return bound(4 * (V * W + pool_len + V * meta_cols + bank_floats),
                 8 * taps * V * W)


def reverb_bound(eff, W: int) -> tuple[float, str]:
    """One pipeline window: ain read, early/late written, the main line
    written, and each ring's touched slots read and written once; against
    ~(120 + 4*e_passes + 9*l_passes) flops per line-sample (the stages in
    csrc/reverb.cu).  Neither counts the chunk loop's latency."""
    rings = (eff.len_late_in, eff.len_early_ap, eff.len_early, eff.len_vecap,
             eff.len_late)
    return bound(4 * 4 * (W + 2 * W + W + sum(2 * min(L, W) for L in rings)),
                 4 * W * (120 + 4 * eff.early_ap_passes
                          + 9 * eff.late_ap_passes))


def profile(scene: str, smi: str) -> None:
    """``--profile best_case|loaded``: the scene at full width, one warm
    512-block call, then torch.profiler over one more.  Prints the device
    time by kernel and by aten op and input shape."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    build_all()
    dev = bench_scene(N_VOICES, N_VOICES, "cuda", loaded=scene == "loaded")
    frames = CHUNK_BLOCKS * BLOCK
    dev.render_samples(frames)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.render_samples(frames)
    wall_plain = time.perf_counter() - t0
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        t0 = time.perf_counter()
        dev.render_samples(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dtime = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=dtime, reverse=True)
    busy_ms = sum(dtime(e) for e in kernels) / 1e3
    emit({"phase": "profile", "scene": scene, "voices": N_VOICES,
          "frames": frames, "wall_ms": 1e3 * wall,
          "wall_ms_unprofiled": 1e3 * wall_plain,
          "x_realtime_unprofiled": (frames / RATE) / wall_plain,
          "device_busy_ms": busy_ms,
          "idle_share": max(0.0, 1.0 - busy_ms / (1e3 * wall)),
          "nvidia_smi": smi})
    for e in kernels[:25]:
        emit({"phase": "profile", "kernel": e.key[:120], "calls": e.count,
              "device_ms": dtime(e) / 1e3})
    total = lambda e: getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0.0)
    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type == DeviceType.CPU and total(e) > 0
                  and e.key.startswith("aten::")), key=total, reverse=True)
    for e in ops[:30]:
        emit({"phase": "profile", "op": e.key, "shapes": str(e.input_shapes)
              [:160], "calls": e.count, "device_ms_total": total(e) / 1e3})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--profile"]:
        profile(sys.argv[2], nvidia_smi())
        return 0
    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen
    from openal_soft_tpu_torch.ops.kernels import resample_unit as rs_unit
    from openal_soft_tpu_torch.ops.kernels import reverb as rev_k

    cuda = torch.device("cuda", 0)
    smi = nvidia_smi()
    wrappers = {"resample_unit": rs_unit.resample_unit,
                "resample_gen": rs_gen.resample_gen,
                "reverb": rev_k.reverb_pipeline}
    report = {name: {"name": name, "route": "cuda",
                     "source": f"openal_soft_tpu_torch/csrc/{name}.cu",
                     "library_ms": None} for name in KERNELS}
    report["resample_unit"]["replaces"] = \
        "openal_soft_tpu/ops/pallas/resample_unit.py:284"
    report["resample_gen"]["replaces"] = \
        "openal_soft_tpu/ops/pallas/resample3.py:113"
    report["reverb"]["replaces"] = "openal_soft_tpu/ops/pallas/reverb.py:219"

    # 1. environment
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build
    build_all()

    # 3. the unit kernel against its plain version on the card
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
    bound_ms, bound_by = resample_bound(V, W, taps, pool.size, 8, V * taps)
    report["resample_unit"].update(max_abs_err=max_err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
    emit({"phase": "timing", "name": "resample_unit", "V": V, "W": W,
          "taps": taps, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "write_GBps": V * W * 4 / (ms * 1e-3) / 1e9, "nvidia_smi": smi})
    del args

    # 5. best_case at full width through the port's entry points
    t0 = time.perf_counter()
    dev = bench_scene(N_VOICES, N_VOICES, "cuda")
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
    report["resample_unit"]["launches"] = rs_unit.resample_unit.launches
    finite = bool(np.isfinite(out).all())
    peak = float(np.abs(out).max())
    emit({"phase": "best_case", "voices": N_VOICES, "frames": frames,
          "setup_s": setup_s, "warm_s": warm_s, "render_s": dt,
          "x_realtime": (frames / RATE) / dt,
          "launches": rs_unit.resample_unit.launches, "finite": finite,
          "peak": peak, "shape": list(out.shape), "nvidia_smi": smi})
    if out.shape != (frames, 2) or not finite or not peak > 0.0:
        raise AssertionError("best_case output is not finite, nonzero "
                             f"[{frames}, 2]: shape {out.shape}, "
                             f"finite {finite}, peak {peak}")
    if rs_unit.resample_unit.launches <= 0:
        raise AssertionError("best_case never launched resample_unit")
    del dev, out

    # 6. best_case on the card against the port on the CPU
    g = bench_scene(64, 64, "cuda")
    c = bench_scene(64, 64, "cpu")
    for n, path in ((8192, "fused"), (4096, "per-block"), (100, "odd"),
                    (924, "odd"), (1, "odd")):
        a, b = g.render_samples(n), c.render_samples(n)
        err = float(np.abs(a - b).max())
        emit({"phase": "parity", "scene": "best_case", "frames": n,
              "path": path, "max_abs_err": err, "tol": PARITY_TOL})
        if not (np.isfinite(a).all() and err <= PARITY_TOL):
            raise AssertionError(f"GPU vs CPU port at {n} frames: {err}")

    # 7-8. the general resampler and the reverb against their plain versions
    report["resample_gen"]["max_abs_err"] = check_gen_kernel(cuda)
    report["reverb"]["max_abs_err"] = check_reverb_kernel(cuda)

    # 9. timing at the loaded scene's shapes: 4096 voices on the 48
    # looping tones at pitch 2**U(-1,1), W = 16*1024, taps = 4
    from openal_soft_tpu_torch.ops import tables

    rng = np.random.default_rng(3)
    bank = {k: torch.tensor(v, device=cuda)
            for k, v in tables.weight_bank().items()}
    gargs = (torch.tensor(pool, device=cuda),
             Ti(8 + (np.arange(N_VOICES) % N_TONES) * RATE), Ti(lens),
             Ti(np.zeros(N_VOICES)), Ti(lens),
             torch.ones(N_VOICES, dtype=torch.bool, device=cuda),
             torch.tensor(rng.random(N_VOICES) < 0.5, device=cuda),
             Ti(rng.integers(0, RATE, N_VOICES)),
             Ti(rng.integers(0, 1 << 16, N_VOICES)),
             Ti(np.floor(2.0 ** rng.uniform(-1, 1, N_VOICES) * 65536)),
             Ti(np.zeros(N_VOICES)),
             torch.tensor(rng.random(N_VOICES).astype(np.float32),
                          device=cuda), bank)
    gsl = rs_gen.slice_bank(bank, taps)
    got = rs_gen.resample_gen(*gargs, W, taps, bank_sl=gsl)
    if not torch.equal(got, rs_gen.resample_gen_ref(*gargs, W, taps)):
        raise AssertionError("resample_gen != plain at the loaded shape")
    del got
    ms = cuda_ms(lambda: rs_gen.resample_gen(*gargs, W, taps, bank_sl=gsl),
                 20, 3)
    plain_ms = cuda_ms(lambda: rs_gen.resample_gen_ref(*gargs, W, taps),
                       5, 1)
    bound_ms, bound_by = resample_bound(N_VOICES, W, taps, pool.size, 12,
                                        gsl.numel() + N_VOICES)
    report["resample_gen"].update(ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
    emit({"phase": "timing", "name": "resample_gen", "V": N_VOICES, "W": W,
          "taps": taps, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "write_GBps": N_VOICES * W * 4 / (ms * 1e-3) / 1e9,
          "nvidia_smi": smi})
    del gargs, gsl
    eff, prm, st = reverb_case(RATE, False, "cuda")
    ain = reverb_windows(rng, W, eff.chunk, cuda, min_chunks=1)[:1]
    ms = cuda_ms(lambda: run_reverb_windows(eff, prm, st, ain, True),
                 20, 3)
    plain_ms = cuda_ms(lambda: run_reverb_windows(eff, prm, st, ain,
                                                  False), 2, 1)
    bound_ms, bound_by = reverb_bound(eff, W)
    report["reverb"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    emit({"phase": "timing", "name": "reverb", "W": W, "chunk": eff.chunk,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "us_per_chunk": 1e3 * ms / (W // eff.chunk), "nvidia_smi": smi})
    del eff, prm, st

    # 10. loaded at full width through the port's entry points
    t0 = time.perf_counter()
    dev = bench_scene(N_VOICES, N_VOICES, "cuda", loaded=True)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev.render_samples(frames)                       # warm
    warm_s = time.perf_counter() - t0
    for name in KERNELS:
        wrappers[name].launches = 0
    t0 = time.perf_counter()
    out = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in KERNELS}
    for name in ("resample_gen", "reverb"):
        report[name]["launches"] = launches[name]
    finite = bool(np.isfinite(out).all())
    peak = float(np.abs(out).max())
    emit({"phase": "loaded", "voices": N_VOICES, "frames": frames,
          "setup_s": setup_s, "warm_s": warm_s, "render_s": dt,
          "x_realtime": (frames / RATE) / dt, "launches": launches,
          "finite": finite, "peak": peak, "shape": list(out.shape),
          "nvidia_smi": smi})
    if out.shape != (frames, 2) or not finite or not peak > 0.0:
        raise AssertionError("loaded output is not finite, nonzero "
                             f"[{frames}, 2]: shape {out.shape}, "
                             f"finite {finite}, peak {peak}")
    if not (launches["resample_gen"] > 0 and launches["reverb"] > 0):
        raise AssertionError(f"loaded skipped a kernel: {launches}")
    del dev, out

    # 11. loaded on the card against the port on the CPU
    g = bench_scene(64, 64, "cuda", loaded=True)
    c = bench_scene(64, 64, "cpu", loaded=True)
    for n, path in ((8192, "fused"), (4096, "per-block"), (100, "odd"),
                    (924, "odd")):
        a, b = g.render_samples(n), c.render_samples(n)
        err = float(np.abs(a - b).max())
        emit({"phase": "parity", "scene": "loaded", "frames": n,
              "path": path, "max_abs_err": err, "tol": LOADED_TOL,
              "peak": float(np.abs(b).max())})
        if not (np.isfinite(a).all() and err <= LOADED_TOL):
            raise AssertionError(f"loaded GPU vs CPU port at {n} frames: "
                                 f"{err}")

    reference = [m for m in sys.modules if m in ("jax", "openal_soft_tpu")
                 or m.startswith(("jax.", "openal_soft_tpu."))]
    if reference:
        raise AssertionError(f"the port imported the JAX package or JAX: "
                             f"{reference[:3]}")

    emit({"kernels": [report[name] for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
