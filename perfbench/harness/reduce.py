"""The benchmark's arithmetic: whole-window rates, device busy
time as the union of operation intervals, and roofline shares against the
card's published peaks.  Every function takes plain numbers or the traced
run's record (``trace.record``), so the tests hold it to hand-made ones."""

from __future__ import annotations

import re

# NVIDIA H100 SXM data sheet: dense peaks at the full 700 W.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "tf32_flops": 495e12}
EARS = 2
RESAMPLE_KERNELS = re.compile(r"unit_kernel|window_kernel")


# --- end to end ---------------------------------------------------------------

def realtime_x(calls: list, frames_per_call: int, rate: int) -> float:
    """Audio seconds that the window's calls completed over the wall
    seconds from the window's start to the end of its last call.
    ``calls``: [(start, end)] on the host clock, the first starting the
    window."""
    audio_s = len(calls) * frames_per_call / rate
    return audio_s / (calls[-1][1] - calls[0][0])


# --- device time ----------------------------------------------------------------

def union_s(intervals: list) -> float:
    """Seconds covered by the union of [start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for s, e in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def gaps(intervals: list, start_us: float, end_us: float) -> list:
    """The idle intervals [(s, e)] between the union's pieces within
    [start_us, end_us)."""
    out, cur = [], start_us
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end_us)))
        cur = max(cur, e)
        if cur >= end_us:
            break
    if cur < end_us:
        out.append((cur, end_us))
    return [(s, e) for s, e in out if e > s]


def busy_s(rec: dict) -> float:
    return union_s([(op[1], op[2]) for op in rec["device_ops"]])


def kernel_s(rec: dict, pattern: re.Pattern) -> float:
    """Summed device seconds of the operations whose name matches."""
    return 1e-6 * sum(op[2] - op[1] for op in rec["device_ops"]
                      if pattern.search(op[0]))


def contraction_s(rec: dict, inner: int) -> float:
    """Device seconds of the kernels launched by the matrix products that
    contract over ``inner`` (``trace.stop_profile`` sums them)."""
    return float(rec.get("products", {}).get(inner, 0.0))


# --- per layer ------------------------------------------------------------------

def launches_per_block(rec: dict) -> float:
    """Device operations (kernels, copies, fills) per 1024-frame block of
    the profiled slice."""
    return len(rec["device_ops"]) / rec["slice"]["blocks"]


def idle_pct(rec: dict) -> float:
    """100 x (1 - device busy per block in the profiled slice / wall per
    block of the run's unprofiled calls)."""
    busy = busy_s(rec) / rec["slice"]["blocks"]
    wall = rec["unprofiled"]["wall_s"] / rec["unprofiled"]["blocks"]
    return 100.0 * (1.0 - busy / wall)


def resample_bytes(voices: int, frames: int, source_bytes: float) -> float:
    """The resampling's least traffic: the distinct source samples its
    outputs need, read once, and the [voices, frames] float32 output
    written once."""
    return source_bytes + 4.0 * voices * frames


def resample_roofline_pct(rec: dict) -> float | None:
    t = kernel_s(rec, RESAMPLE_KERNELS)
    if t <= 0.0:
        return None
    w = rec["work"]
    nbytes = resample_bytes(w["voices"], rec["slice"]["frames"],
                            w["source_bytes"])
    return 100.0 * (nbytes / PEAKS["hbm_bytes_per_s"]) / t


def hrtf_bound_s(voices: int, frames: int, taps: int) -> float:
    """The HRTF contraction's least time: 2 x 2 ears x taps x voices x
    frames operations at the TF32 tensor peak, against the [voices, frames]
    float32 input and the [2, frames] output at the HBM rate; ``taps`` are
    those the HRIR set stores (its ``ir_size``)."""
    flops = 2.0 * EARS * taps * voices * frames
    nbytes = 4.0 * (voices * frames + EARS * frames)
    return max(flops / PEAKS["tf32_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def hrtf_roofline_pct(rec: dict) -> float | None:
    """The HRTF contraction's bound over the time of the kernels of every
    matrix product that contracts over the voices: the products of the
    block's samples and of the voices' history with the delay-shifted
    HRIRs.  A product over other operands (a decode matrix over
    ambisonic channels) is not counted."""
    t = contraction_s(rec, rec["work"]["voices"])
    if t <= 0.0:
        return None
    w = rec["work"]
    return 100.0 * hrtf_bound_s(w["voices"], rec["slice"]["frames"],
                                w["hrir_taps"]) / t
