"""One EAXReverb pipeline over a window: plain version and the Hopper
kernel's wrapper.

A pipeline (alc/effects/reverb.cpp ReverbPipeline) turns the 4-line
A-format input ``ain`` [4, W] into early and late output lines [4, W], in
chunks of ``chunk`` samples (the reference's MAX_UPDATE_SAMPLES loop).
Per chunk, early then late:

  early: crossfaded main-line taps -> master low/high shelves (biquads) ->
         Allpass4 -> reflect into the early delay line, combined with its
         delayed read -> scatter into the late-input line;
  late:  cubic-interpolated modulated read of the late line -> T60 high
         and low shelves -> late-input taps with the density-gain fade ->
         vector all-pass -> reverse, scatter and refeed the late line.

The all-pass recurrences are solved by fixed-point passes (the tap stream
depends on this chunk's writes only at lags >= the all-pass offset), and
the biquads use the balanced companion form of ``ops/filters.py`` — both
as in the JAX package's ``effects/reverb.py`` ``_run_pipeline``, with the
same f32 operand order, except that each chunk runs its early and its late
half before the next chunk starts (the JAX jnp path runs every early chunk
of a window first, which at windows wider than the late-input line reads
ring slots that later chunks of the same window have overwritten; ROADMAP
C5).  The rings are power-of-two lines indexed modulo their length.

State, updated in place: ``main`` (written with ``ain`` at ``offset`` when
``write_main``), the pipeline's five rings, four biquad states, the
modulation index and the serial of the last parameter crossfade.  The
parameters come packed (``pack_params``): ``pi`` int32 [34] and ``pf`` f32
[63].

``reverb_pipeline`` takes CPU tensors to ``reverb_pipeline_ref`` and CUDA
tensors to the kernel in ``csrc/reverb.cu`` (which replaces the TPU kernel
``openal_soft_tpu/ops/pallas/reverb.py`` ``_kernel``).  On the card there
is no fallback: the kernel launches or the wrapper raises.
``reverb_pipeline.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import filters as f_ops
from ._build import check_tensor, load_library

NL = 4
RINGS = ("late_in", "early_ap", "early_dl", "vecap", "late_dl")
ZSTATES = ("lp_z", "hp_z", "t60_hf_z", "t60_lf_z")
N_PI = 34
N_PARAMS = 63                   # pf's parameters; the filter constants follow
N_KC = 12 + 2 * 32              # constants per (filter, line), see filter_consts
N_PF = N_PARAMS + 4 * NL * N_KC
_MOD_FRACMASK = (1 << 24) - 1
_MOD_HALF = 1 << 23
_U32 = 0xFFFFFFFF


def pack_params(p: dict, prefix: str = "") -> tuple[np.ndarray, np.ndarray]:
    """Host numpy parameters of one pipeline (``ReverbEffect.update``'s
    keys, with ``prefix`` for the old pipeline) -> (pi int32 [34], pf f32
    [63]) in the kernel's layout:

      pi: early_taps0[4] early_taps1[4] late_taps0[4] late_taps1[4]
          e_ap_off[4] e_off[4] l_ap_off[4] l_off[4] mod_step serial
      pf: early_coeff0 early_coeff1 e_coeff density_gain e_ap_coeff
          l_ap_coeff mix_x mix_y mod_depth t60_mid[4] lp[5] hp[5]
          t60_hf[4,5] t60_lf[4,5], then ``filter_consts`` of the four
          filters (computed here, once per parameter change, so that the
          kernel does not recompute them per launch)
    """
    g = lambda k: np.asarray(p[prefix + k])
    pi = np.concatenate([
        g(k).astype(np.int32).reshape(-1) for k in (
            "early_taps0", "early_taps1", "late_taps0", "late_taps1",
            "e_ap_off", "e_off", "l_ap_off", "l_off")] + [
        g("mod_step").astype(np.uint32).view(np.int32).reshape(1),
        np.asarray(p["serial"], np.int32).reshape(1)])
    pf = np.concatenate([g(k).astype(np.float32).reshape(-1) for k in (
        "early_coeff0", "early_coeff1", "e_coeff", "density_gain",
        "e_ap_coeff", "l_ap_coeff", "mix_x", "mix_y", "mod_depth",
        "t60_mid", "lp", "hp", "t60_hf", "t60_lf")])
    pf = np.concatenate([pf, filter_consts(pf)])
    assert pi.shape == (N_PI,) and pf.shape == (N_PF,)
    return pi, pf


def filter_consts(pf: np.ndarray) -> np.ndarray:
    """The balanced-companion constants of the pipeline's four filters (lp,
    hp, t60_hf, t60_lf) per line, by ``ops/filters.biquad_consts`` on the
    CPU: per (filter, line) b0, A00, A01, A10, A11, B0, B1, delta, the four
    entries of A^32, then the rows C*A^k, k < 32, of each state component.
    pf: the 63 packed parameters.  Returns f32 [4 * NL * N_KC]."""
    p = torch.from_numpy(np.asarray(pf[:N_PARAMS], np.float32))
    out = []
    for cf in (p[13:18].expand(NL, 5), p[18:23].expand(NL, 5),
               p[23:43].reshape(NL, 5), p[43:63].reshape(NL, 5)):
        k = f_ops.biquad_consts(cf[None])
        rows = [k["b0"], *k["A"], *k["B"], k["delta"].expand_as(k["b0"]),
                *k["M"]]
        out.append(torch.cat([torch.stack([r[0] for r in rows], -1),
                              k["ws"][0][:, 0].T, k["ws"][1][:, 0].T], -1))
    return torch.stack(out).numpy().reshape(-1)


def early_ahead_ok(len_late_in: int, max_late_tap: int, chunk: int) -> bool:
    """Whether the kernel may run chunk k+1's early half beside chunk k's
    late half: the early half writes late_in at [off + chunk, off +
    2*chunk) while the late half reads it at lags >= 0 behind [off, off +
    chunk), so the two never meet in the ring when it is at least the
    largest late tap (the crossfade's old taps included) plus two chunks
    long."""
    return len_late_in >= max_late_tap + 2 * chunk


# --- plain version ------------------------------------------------------------


def _read(ring: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """ring[l, (start[l] + j) mod L] for j < n: [NL, n]."""
    j = torch.arange(n, dtype=torch.int64, device=ring.device)
    idx = (start.reshape(-1, 1) + j[None, :]) & (ring.shape[1] - 1)
    return ring.gather(1, idx.expand(NL, n))


def _write(ring: torch.Tensor, off: torch.Tensor, values: torch.Tensor):
    n = values.shape[1]
    j = torch.arange(n, dtype=torch.int64, device=ring.device)
    ring.index_copy_(1, (off + j) & (ring.shape[1] - 1), values)


def _scatter(s0, s1, s2, s3, mix_x, mix_y) -> torch.Tensor:
    """VectorPartialScatter (reverb.cpp:1385-1394) of four [n] rows."""
    return torch.stack([
        mix_x * s0 + mix_y * (s1 - s2 + s3),
        mix_x * s1 + mix_y * (-s0 + s2 + s3),
        mix_x * s2 + mix_y * (s0 - s1 + s3),
        mix_x * s3 + mix_y * (-s0 - s1 - s2)])


def _shifter(lags: torch.Tensor, CH: int):
    """x -> rows delayed by per-row lags with zero fill (x[l, i - lag])."""
    i = torch.arange(CH, dtype=torch.int64, device=lags.device)
    src = i[None, :] - lags.clamp(0, CH)[:, None]
    valid = src >= 0
    srcc = src.clamp(min=0)
    return lambda x: torch.where(valid, x.gather(1, srcc), 0.0)


def reverb_pipeline_ref(ain, main, st, pi, pf, offset, ctab, *,
                        write_main: bool, chunk: int, e_passes: int,
                        l_passes: int, mod_win: int):
    """Plain torch version of the kernel: returns (early, late) [4, W]."""
    CH = chunk
    W = ain.shape[1]
    dev = ain.device
    ints = pi.to(torch.int64)
    et0, et1, lt0, lt1 = ints[0:4], ints[4:8], ints[8:12], ints[12:16]
    e_ap_off, e_off, l_ap_off, l_off = (ints[16:20], ints[20:24],
                                        ints[24:28], ints[28:32])
    mod_step = ints[32] & _U32
    serial = ints[33]
    (ec0, ec1, e_coeff, density_gain, e_ap_coeff, l_ap_coeff, mix_x, mix_y,
     mod_depth) = pf[:9]
    t60_mid = pf[9:13]
    k_lp = f_ops.biquad_consts(pf[13:18].expand(CH // 32, NL, 5))
    k_hp = f_ops.biquad_consts(pf[18:23].expand(CH // 32, NL, 5))
    k_hf = f_ops.biquad_consts(pf[23:43].reshape(NL, 5).expand(CH // 32, NL, 5))
    k_lf = f_ops.biquad_consts(pf[43:63].reshape(NL, 5).expand(CH // 32, NL, 5))

    off0 = offset.to(torch.int64)
    if write_main:
        _write(main, off0, ain)
    do_fade0 = st["serial_done"] != serial
    i_ch = torch.arange(CH, dtype=torch.int64, device=dev)
    i_chf = torch.arange(CH, dtype=torch.float32, device=dev)
    fade_step = 1.0 / CH
    fadec = i_chf * fade_step
    use_eap = i_ch[None, :] < e_ap_off[:, None]
    use_ewin = i_ch[None, :] < e_off[:, None]
    use_vap = i_ch[None, :] < l_ap_off[:, None]
    shift_eap, shift_e, shift_vap = (_shifter(e_ap_off, CH),
                                     _shifter(e_off, CH),
                                     _shifter(l_ap_off, CH))
    reflect = torch.full((NL, NL), -0.5, dtype=torch.float32, device=dev)
    reflect.diagonal().fill_(0.5)
    md256 = mod_depth * 256.0
    Wl = CH + mod_win
    z = {k: st[k] for k in ZSTATES}
    mod_index = st["mod_index"].to(torch.int64)
    early = torch.empty((NL, W), dtype=torch.float32, device=dev)
    late = torch.empty_like(early)

    for k in range(W // CH):
        off = off0 + k * CH
        if k == 0:
            tap0 = torch.where(do_fade0, et0, et1)
            c0 = torch.where(do_fade0, ec0, ec1)
            ltap0 = torch.where(do_fade0, lt0, lt1)
        else:
            tap0, c0, ltap0 = et1, ec1, lt1

        # Early: two decorrelated main-line taps with an in-chunk crossfade.
        w0 = _read(main, off - tap0, CH)
        w1 = _read(main, off - et1, CH)
        tmp = w0 * c0 * (1.0 - fadec) + w1 * ec1 * fadec
        tmp, z["lp_z"] = f_ops.biquad_apply(tmp, z["lp_z"], k_lp)
        tmp, z["hp_z"] = f_ops.biquad_apply(tmp, z["hp_z"], k_hp)
        # Allpass4 by fixed-point passes.
        win = _read(st["early_ap"], off - e_ap_off, CH)
        d = tmp
        for _ in range(e_passes):
            y = torch.where(use_eap, win, shift_eap(d)) - e_ap_coeff * tmp
            d = tmp + e_ap_coeff * y
        yap = torch.where(use_eap, win, shift_eap(d)) - e_ap_coeff * tmp
        _write(st["early_ap"], off, d)
        tmp = yap
        # Reflect into the early delay, combined with its delayed read.
        refl = (reflect[:, 0:1] * tmp[0] + reflect[:, 1:2] * tmp[1]
                + reflect[:, 2:3] * tmp[2] + reflect[:, 3:4] * tmp[3])
        _write(st["early_dl"], off, refl)
        ewin = _read(st["early_dl"], off - e_off, CH)
        dread = torch.where(use_ewin, ewin, shift_e(refl))
        early[:, k * CH:(k + 1) * CH] = dread * e_coeff + tmp
        # Scatter into the late-input line.
        _write(st["late_in"], off,
               _scatter(tmp[0], tmp[1], tmp[2], tmp[3], mix_x, mix_y))

        # Late: modulated feedback read with cubic interpolation.
        iidx = (mod_index + i_ch * mod_step) & _U32
        xm = (iidx & _MOD_FRACMASK).to(torch.float32) * (1.0 / (1 << 24))
        lfo = torch.where((iidx & _MOD_HALF) == 0,
                          (-16.0 * xm) * xm + 8.0 * xm,
                          (16.0 * xm) * xm - 24.0 * xm + 8.0)
        idelay = ((lfo + 1.0) * md256).to(torch.int64)
        mod_index = (mod_index + CH * mod_step) & _U32
        lwin = _read(st["late_dl"], off - (l_off + mod_win), Wl)
        pos = i_ch - (idelay >> 8) + mod_win
        cw = ctab[idelay & 255]                                   # [CH, 4]
        acc = torch.zeros((NL, CH), dtype=torch.float32, device=dev)
        for tap in range(4):
            g = lwin.gather(1, (pos - tap).clamp(0, Wl - 1).expand(NL, CH))
            acc = acc + g * cw[:, tap]
        tmp = acc * t60_mid[:, None]
        tmp, z["t60_hf_z"] = f_ops.biquad_apply(tmp, z["t60_hf_z"], k_hf)
        tmp, z["t60_lf_z"] = f_ops.biquad_apply(tmp, z["t60_lf_z"], k_lf)
        # Late-input taps with the density-gain fade.
        lw0 = _read(st["late_in"], off - ltap0, CH)
        lw1 = _read(st["late_in"], off - lt1, CH)
        step = torch.where(ltap0 != lt1, density_gain * fade_step, 0.0)
        fade0 = density_gain - step[:, None] * i_chf[None, :]
        fade1 = step[:, None] * i_chf[None, :]
        tmp = tmp + lw0 * fade0 + lw1 * fade1
        # Vector all-pass by fixed-point passes.
        vwin = _read(st["vecap"], off - l_ap_off, CH)
        d = tmp
        for _ in range(l_passes):
            y = torch.where(use_vap, vwin, shift_vap(d)) - l_ap_coeff * tmp
            u = tmp + l_ap_coeff * y
            d = _scatter(u[0], u[1], u[2], u[3], mix_x, mix_y)
        out = torch.where(use_vap, vwin, shift_vap(d)) - l_ap_coeff * tmp
        _write(st["vecap"], off, d)
        late[:, k * CH:(k + 1) * CH] = out
        # Reverse, scatter and refeed the late line.
        _write(st["late_dl"], off,
               _scatter(out[3], out[2], out[1], out[0], mix_x, mix_y))

    for k in ZSTATES:
        st[k].copy_(z[k])
    st["mod_index"].copy_(mod_index)
    st["serial_done"].copy_(serial)
    return early, late


# --- the kernel ---------------------------------------------------------------


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    fn = load_library("reverb").reverb_pipeline_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P, I, I, P, P, I]          # ain, W, write_main, offset, main, Lm
                   + [P, I] * len(RINGS)       # rings and their lengths
                   + [P] * len(ZSTATES)        # biquad states
                   + [P, P, P, P, P, P, P]     # mod_index, serial_done, pi, pf, ctab, early, late
                   + [I, I, I, I, I, P])       # chunk, e_passes, l_passes, mod_win, ahead, stream
    fn.restype = ctypes.c_int
    return fn


def _ring(name: str, x: torch.Tensor, device) -> None:
    L = x.shape[-1]
    check_tensor(name, x, torch.float32, (NL, L), device)
    if L <= 0 or L & (L - 1):
        raise ValueError(f"{name}: ring length {L} is not a power of two")


def reverb_pipeline(ain, main, st, pi, pf, offset, ctab, *, write_main: bool,
                    chunk: int, e_passes: int, l_passes: int, mod_win: int,
                    max_late_tap: int | None = None):
    """Run one pipeline over ain [4, W]: returns (early, late) [4, W] f32.

    ``st`` holds the pipeline's state tensors (``RINGS``, ``ZSTATES``,
    ``mod_index`` and ``serial_done``, both int64 0-d); ``offset`` is the
    0-d int64 ring offset of the window's first sample; ``ctab`` the
    [256, 4] cubic modulation table.  CPU tensors run the plain version;
    CUDA tensors launch the kernel on the current stream.  ``max_late_tap``
    is the host's bound on the pipeline's late taps (the crossfade's old
    ones included): where ``early_ahead_ok`` holds for it the kernel runs
    chunk k+1's early half beside chunk k's late half; without it, or where
    it fails, the kernel runs the halves in order.  Both give the same
    values."""
    if ain.device.type == "cpu":
        return reverb_pipeline_ref(ain, main, st, pi, pf, offset, ctab,
                                   write_main=write_main, chunk=chunk,
                                   e_passes=e_passes, l_passes=l_passes,
                                   mod_win=mod_win)
    if ain.device.type != "cuda":
        raise ValueError(f"reverb_pipeline: unsupported device {ain.device}")
    W = ain.shape[1]
    if chunk not in (32, 64, 128, 256) or W <= 0 or W % chunk:
        raise ValueError(f"reverb_pipeline: chunk {chunk} must be 32..256 "
                         f"and divide W={W}")
    if e_passes < 0 or l_passes < 0 or mod_win < 0:
        raise ValueError("reverb_pipeline: negative pass count or window")
    dev = ain.device
    check_tensor("ain", ain, torch.float32, (NL, W), dev)
    _ring("main", main, dev)
    if W > main.shape[1]:
        raise ValueError(f"reverb_pipeline: W={W} exceeds the main line")
    for k in RINGS:
        _ring(k, st[k], dev)
    for k in ZSTATES:
        check_tensor(k, st[k], torch.float32, (NL, 2), dev)
    for k in ("mod_index", "serial_done"):
        check_tensor(k, st[k], torch.int64, (), dev)
    check_tensor("offset", offset, torch.int64, (), dev)
    check_tensor("pi", pi, torch.int32, (N_PI,), dev)
    check_tensor("pf", pf, torch.float32, (N_PF,), dev)
    check_tensor("ctab", ctab, torch.float32, (256, 4), dev)
    early = torch.empty((NL, W), dtype=torch.float32, device=dev)
    late = torch.empty_like(early)
    args = [ain.data_ptr(), W, int(bool(write_main)), offset.data_ptr(),
            main.data_ptr(), main.shape[1]]
    for k in RINGS:
        args += [st[k].data_ptr(), st[k].shape[1]]
    args += [st[k].data_ptr() for k in ZSTATES]
    args += [st["mod_index"].data_ptr(), st["serial_done"].data_ptr(),
             pi.data_ptr(), pf.data_ptr(), ctab.data_ptr(), early.data_ptr(),
             late.data_ptr(), chunk, e_passes, l_passes, mod_win,
             int(max_late_tap is not None and early_ahead_ok(
                 st["late_in"].shape[1], max_late_tap, chunk))]
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"reverb kernel launch failed: CUDA error {err}")
    reverb_pipeline.launches += 1
    return early, late


reverb_pipeline.launches = 0
