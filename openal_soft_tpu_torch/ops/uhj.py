"""UHJ / Super Stereo codecs (core/uhjfilter.cpp, core/tsmefilter.cpp) and
the wide-band +90 degree phase shifter (common/phase_shifter.hpp), on
torch tensors (port of ops/uhj.py).

The phase shift is a linear FIR whose even-offset taps are zero; whole
blocks go through one batched FFT correlation (``torch.fft``):

    j(x)[i] = sum_j c[j] * x[i + 2*j]        (j in [0, N/2))

Decode equations (uhjfilter.cpp:280-298, N3D output scaling):
    S = L + R,  D = L - R
    W = 0.981532*S + 0.161245010788*j(1.01449414406*D + 0.940383607152*T)
    X = 0.512550829698*S -          j(1.01449414406*D + 0.940383607152*T)
    Y = 0.974857725791*D - 0.82840763305*T + j(0.228577809582*S)
    Z = 1.25332058063*Q

Super Stereo decode (uhjfilter.cpp:429-446; w the width, <= 0.7):
    S = L + R,  D = (L - R) * w
    W = 0.6098637*S + 0.6896511*j(D)
    X = 1.05631501729*S - 0.934107402059*j(D)
    Y = 2.06031664957*D + 0.264078754323*j(S)

Three quality tiers: the FIR decoders and encoders at 256 or 512 taps
(each voice consumes T + N/2 input samples per block plus an N/2-1 sample
carried history), and the default IIR tier, whose phase shifts are two
cascades of four all-pass sections (core/allpass_iir.hpp).  Each section,
y = a*x + z0; z0' = z1; z1' = a*y - x, is a TDF2 biquad with the fixed
coefficients [a, 0, -1, 0, -a], so ``_allpass4`` runs a cascade as one
four-section ``biquad_dual`` call at counter 0: the biquad kernel on the
card, its sample-sequential plain version on the CPU.  The
streams of one decode or encode that share a cascade run as rows of one
call.  The sample-sequential TDF2 rounds as the reference's all-pass
does; the JAX package runs the sections chunk-parallel, so the two differ
by float32 rounding (``tests/test_torch_uhj.py`` states the bound).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .kernels import biquad as biq

f32 = np.float32

FILTER_SIZE = 256          # UhjQualityType::FIR256


def fir_pad(n: int = FILTER_SIZE) -> int:
    return n // 2


def fir_hist(n: int = FILTER_SIZE) -> int:
    return n // 2 - 1


# Decoder scale factors (uhjfilter.cpp:280-298)
W_S, W_JDT = 0.981532, 0.161245010788
X_S = 0.512550829698
Y_D, Y_T, Y_JS = 0.974857725791, -0.82840763305, 0.228577809582
Z_Q = 1.25332058063
DT_D, DT_T = 1.01449414406, 0.940383607152

# Super Stereo (uhjfilter.cpp:448-523)
SS_W_S, SS_W_JD = 0.6098637, 0.6896511
SS_X_S, SS_X_JD = 1.05631501729, -0.934107402059
SS_Y_D, SS_Y_JS = 2.06031664957, 0.264078754323


def _c(v) -> float:
    """A constant rounded to float32, as the JAX package multiplies by
    np.float32 scalars."""
    return float(f32(v))


@functools.lru_cache
def phase_shifter_coeffs(n: int = FILTER_SIZE) -> np.ndarray:
    """PhaseShifterT<N> coefficients (phase_shifter.hpp:62-83), f64 gen."""
    half = n // 2
    c = np.zeros(half)
    for i in range(half):
        k = (i * 2 + 1) - half
        w = 2.0 * np.pi / (half - 1) * i
        window = (0.3635819 - 0.4891775 * np.cos(w) + 0.1365995 * np.cos(2 * w)
                  - 0.0106411 * np.cos(3 * w))
        c[i] = window * 2.0 / (np.pi * k)
    return c.astype(f32)


@functools.lru_cache
def _shift_kernel_fft(nfft: int, n: int = FILTER_SIZE) -> np.ndarray:
    """conj(rfft(k2)) for the strided correlation kernel k2[2j] = c[j]."""
    c = phase_shifter_coeffs(n)
    k2 = np.zeros(n - 1, f32)
    k2[0::2] = c
    return np.conj(np.fft.rfft(k2, nfft)).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _shift_kernel(nfft: int, n: int, device: torch.device) -> torch.Tensor:
    """_shift_kernel_fft on ``device`` (read-only, shared by callers)."""
    return torch.tensor(_shift_kernel_fft(nfft, n), device=device)


def phase_shift(x_ext: torch.Tensor, T: int,
                n: int = FILTER_SIZE) -> torch.Tensor:
    """Batched +90 degree shift: x_ext [B, T + N - 1] -> [B, T].

    y[i] = sum_j c[j] * x_ext[i + 2j], via one FFT correlation per line."""
    L = x_ext.shape[-1]
    nfft = 1
    while nfft < L:
        nfft <<= 1
    K = _shift_kernel(nfft, n, x_ext.device)
    Y = torch.fft.rfft(x_ext, n=nfft, dim=-1) * K
    return torch.fft.irfft(Y, n=nfft, dim=-1)[..., :T].to(torch.float32)


def uhj_decode(chans: torch.Tensor, dt_hist: torch.Tensor,
               s_hist: torch.Tensor, T: int, n_input: int,
               n: int = FILTER_SIZE):
    """Batched UHJ2/3/4 FIR decode (UhjDecoder::decode,
    uhjfilter.cpp:300-361).

    chans [U, C, T + n//2] (C = 3 or 4; UHJ2 voices have a zero-filled
    third line); dt_hist/s_hist [U, n//2 - 1] carried shifter histories;
    n_input 2, 3 or 4 (buffer channels).
    Returns (out [U, C, T] with W/X/Y[/Z], dt_hist', s_hist')."""
    left, right = chans[:, 0], chans[:, 1]
    tch = chans[:, 2] if n_input >= 3 else torch.zeros_like(left)
    s = left + right
    d = left - right

    hist = fir_hist(n)
    dt = _c(DT_D) * d + _c(DT_T) * tch                   # [U, T+n/2]
    dt_ext = torch.cat([dt_hist, dt], dim=1)             # [U, T+N-1]
    jdt = phase_shift(dt_ext, T, n)
    new_dt_hist = dt_ext[:, T:T + hist]

    s_ext = torch.cat([s_hist, s], dim=1)
    js = phase_shift(s_ext, T, n)
    new_s_hist = s_ext[:, T:T + hist]

    st, dtr, tt = s[:, :T], d[:, :T], tch[:, :T]
    w = _c(W_S) * st + _c(W_JDT) * jdt
    x = _c(X_S) * st - jdt
    y = _c(Y_D) * dtr + _c(Y_T) * tt + _c(Y_JS) * js
    outs = [w, x, y]
    if chans.shape[1] >= 4:
        outs.append(_c(Z_Q) * chans[:, 3, :T])
    return torch.stack(outs, dim=1), new_dt_hist, new_s_hist


def super_stereo_decode(chans: torch.Tensor, dt_hist: torch.Tensor,
                        s_hist: torch.Tensor, width: torch.Tensor, T: int,
                        n: int = FILTER_SIZE, j_sign: float = 1.0):
    """Batched Super Stereo FIR decode (UhjStereoDecoder,
    uhjfilter.cpp:430-523).

    chans [U, 3, T + n//2] (third line zero); width [U].  ``j_sign=-1``
    gives the TSME stereo decoder (core/tsmefilter.cpp:332-430: the same
    matrix with the phase shift reversed)."""
    hist = fir_hist(n)
    left, right = chans[:, 0], chans[:, 1]
    s = left + right
    d = (left - right) * width[:, None]

    d_ext = torch.cat([dt_hist, d], dim=1)
    jd = phase_shift(d_ext, T, n) * _c(j_sign)
    new_dt_hist = d_ext[:, T:T + hist]

    s_ext = torch.cat([s_hist, s], dim=1)
    js = phase_shift(s_ext, T, n) * _c(j_sign)
    new_s_hist = s_ext[:, T:T + hist]

    st, dtr = s[:, :T], d[:, :T]
    w = _c(SS_W_S) * st + _c(SS_W_JD) * jd
    x = _c(SS_X_S) * st + _c(SS_X_JD) * jd
    y = _c(SS_Y_D) * dtr + _c(SS_Y_JS) * js
    return torch.stack([w, x, y], dim=1), new_dt_hist, new_s_hist


# --- UHJ output encoder (UhjEncoder, uhjfilter.cpp:82-215) ------------------

ENC_S_W, ENC_S_X = 0.4698463, 0.0757602682546
ENC_JD_W, ENC_JD_X = -0.17101005, 0.208149636675
ENC_D_Y = 0.267586995182
ENC_SEGMENT = 128                           # sSegmentSize = sFftLength/2


class UhjEncoderState:
    """Stereo-UHJ FIR output post-process, block-batched (UhjEncoder<N>,
    uhjfilter.cpp:82-215; n = 256 or 512 taps).

    The direct S path is delayed by sFilterDelay (= n/2 + 128) to align with
    the shifted D path; the state carries the delayed W/X/Y tails and the
    shifter history."""

    def __init__(self, n: int = FILTER_SIZE):
        self.n = n
        self.delay = n // 2 + ENC_SEGMENT

    def init(self, device) -> dict:
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
        return {"wxy": z(3, self.delay),
                "jwx_hist": z(fir_hist(self.n) + self.delay)}

    def encode(self, state: dict, w, x, y, T: int):
        """(state, W,X,Y [T]) -> (state', left [T], right [T])."""
        d = self.delay
        wd = torch.cat([state["wxy"][0], w])
        xd = torch.cat([state["wxy"][1], x])
        yd = torch.cat([state["wxy"][2], y])
        new_wxy = torch.stack([wd[T:], xd[T:], yd[T:]])

        # j(-0.17101005*W + 0.208149636675*X) on the undelayed signal, so
        # the shifter's n/2-1 causal core lines up with the S delay.
        wx = _c(ENC_JD_W) * w + _c(ENC_JD_X) * x
        wx_ext = torch.cat([state["jwx_hist"], wx])
        jwx = phase_shift(wx_ext[None], T, self.n)[0]
        new_hist = wx_ext[T:T + fir_hist(self.n) + d]

        s = _c(ENC_S_W) * wd[:T] + _c(ENC_S_X) * xd[:T]
        dd = jwx + _c(ENC_D_Y) * yd[:T]
        return ({"wxy": new_wxy, "jwx_hist": new_hist}, s + dd, s - dd)


class TsmeEncoderState:
    """Stereo-TSME FIR output post-process (TsmeEncoder<N>,
    tsmefilter.cpp:138-278): like the UHJ encoder but the height channel
    folds into S and the inputs arrive in ACN order (W, Y, Z, X)."""

    def __init__(self, n: int = FILTER_SIZE):
        self.n = n
        self.delay = n // 2 + ENC_SEGMENT

    def init(self, device) -> dict:
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
        return {"wyzx": z(4, self.delay),
                "jwx_hist": z(fir_hist(self.n) + self.delay)}

    def encode(self, state: dict, w, y, z, x, T: int):
        d = self.delay
        wd = torch.cat([state["wyzx"][0], w])
        yd = torch.cat([state["wyzx"][1], y])
        zd = torch.cat([state["wyzx"][2], z])
        xd = torch.cat([state["wyzx"][3], x])
        new_wyzx = torch.stack([wd[T:], yd[T:], zd[T:], xd[T:]])

        wx = _c(TSME_D_W) * w + _c(TSME_D_X) * x
        wx_ext = torch.cat([state["jwx_hist"], wx])
        jwx = phase_shift(wx_ext[None], T, self.n)[0]
        new_hist = wx_ext[T:T + fir_hist(self.n) + d]

        s = (_c(TSME_S_W) * wd[:T] + _c(TSME_S_X) * xd[:T]
             + _c(TSME_S_Z) * zd[:T])
        dd = jwx + _c(TSME_D_Y) * yd[:T]
        return ({"wyzx": new_wyzx, "jwx_hist": new_hist}, s + dd, s - dd)


# --- IIR quality tier (the default: UhjQualityType::Default == IIR) ----------
#
# core/allpass_iir.hpp: Filter1 gives an N-degree phase shift (applied to
# the direct paths) and Filter2 N+90 degrees (applied one sample ahead: the
# j() operator with sInputPadding = 1).

FILTER1_COEFF = np.array([0.479400865589, 0.876218493539,
                          0.976597589508, 0.997499255936], f32)
FILTER2_COEFF = np.array([0.161758498368, 0.733028932341,
                          0.945349700329, 0.990599156684], f32)


def _prime4(x0: torch.Tensor, state: torch.Tensor, coeffs: np.ndarray):
    """processOne state priming for the +90 filters (allpass_iir.hpp:35-48).

    The reference consumes the stream's first sample once before the first
    block (the j() filters run one sample ahead).  Priming applies whenever
    the filter state is still all-zero: a zero state means no nonzero input
    was ever consumed, which is exactly the not-yet-primed condition."""
    allzero = (state == 0.0).all(dim=2).all(dim=1)           # [B]
    x = x0
    cols = []
    for i in range(4):
        a = float(coeffs[i])
        y = a * x
        cols.append(torch.stack([torch.zeros_like(x), a * y - x], dim=-1))
        x = y
    primed = torch.stack(cols, dim=1)                        # [B, 4, 2]
    return torch.where(allzero[:, None, None], primed, state)


@functools.lru_cache(maxsize=64)
def _sections(coeffs: bytes, B: int, device) -> tuple:
    """The cascade's four sections as biquad coefficients [B, 4, 5], each
    [a, 0, -1, 0, -a], and a zero counter [B] (read-only, shared by
    callers); ``coeffs`` the four float32 coefficients' bytes."""
    rows = np.array([[a, 0.0, -1.0, 0.0, -a]
                     for a in np.frombuffer(coeffs, f32)], f32)
    t = torch.tensor(rows, device=device)
    return (t.expand(B, 4, 5).contiguous(),
            torch.zeros(B, dtype=torch.int32, device=device))


def _allpass4(xs: list, states: list, coeffs: np.ndarray):
    """Four cascaded all-pass sections over the rows of ``xs`` (each
    [b_i, T]) from ``states`` (each [b_i, 4, 2]): one four-section
    biquad_dual launch for all rows.  Returns ([y_i [b_i, T]],
    [state_i'])."""
    x = torch.cat(xs, dim=0)      # a new contiguous, aligned tensor
    z = torch.cat(states, dim=0)
    cf, cnt = _sections(coeffs.tobytes(), x.shape[0], x.device)
    y, z2, _, _ = biq.biquad_dual(x, z, cf, cf, cnt)
    sizes = [t.shape[0] for t in xs]
    return list(torch.split(y, sizes)), list(torch.split(z2, sizes))


def uhj_decode_iir(chans: torch.Tensor, st: dict, T: int, n_input: int):
    """Batched UhjDecoderIIR::decode (uhjfilter.cpp:362-424).

    chans [U, C, >= T+1]; st {"f2dt","f1s","f1dt","f2s"[,"f1q"]}: [U,4,2].
    The one-sample state priming of the very first block (processOne) is
    applied to an all-zero state (``_prime4``).  Returns (out [U, C, T],
    st')."""
    left, right = chans[:, 0], chans[:, 1]
    tch = chans[:, 2] if n_input >= 3 else torch.zeros_like(left)
    s = left + right
    d = left - right
    dt = _c(DT_D) * d + _c(DT_T) * tch

    (jdt, js), (f2dt, f2s) = _allpass4(
        [dt[:, 1:T + 1], s[:, 1:T + 1]],
        [_prime4(dt[:, 0], st["f2dt"], FILTER2_COEFF),
         _prime4(s[:, 0], st["f2s"], FILTER2_COEFF)], FILTER2_COEFF)
    dty = _c(Y_D) * d[:, :T] + _c(Y_T) * tch[:, :T]
    quad = chans.shape[1] >= 4
    f1_in = [s[:, :T], dty] + ([chans[:, 3, :T]] if quad else [])
    f1_st = [st["f1s"], st["f1dt"]] + ([st["f1q"]] if quad else [])
    f1_out, f1_st2 = _allpass4(f1_in, f1_st, FILTER1_COEFF)
    f1s_y, f1dt_y = f1_out[0], f1_out[1]

    w = _c(W_S) * f1s_y + _c(W_JDT) * jdt
    x = _c(X_S) * f1s_y - jdt
    y = f1dt_y + _c(Y_JS) * js
    outs = [w, x, y]
    new_st = {"f2dt": f2dt, "f1s": f1_st2[0], "f1dt": f1_st2[1], "f2s": f2s}
    if quad:
        outs.append(_c(Z_Q) * f1_out[2])
        new_st["f1q"] = f1_st2[2]
    return torch.stack(outs, dim=1), new_st


def super_stereo_decode_iir(chans: torch.Tensor, st: dict,
                            width: torch.Tensor, T: int,
                            j_sign: float = 1.0):
    """Batched UhjStereoDecoderIIR::decode (uhjfilter.cpp:525-600).

    Width changes apply immediately (the reference interpolates the width
    over the first block after a change; a one-block transient).
    ``j_sign=-1`` is the TSME stereo decoder (tsmefilter.cpp:429-505)."""
    left, right = chans[:, 0], chans[:, 1]
    s = left + right
    d = (left - right) * width[:, None]

    (f1s_y, f1d_y), (f1s, f1dt) = _allpass4(
        [s[:, :T], d[:, :T]], [st["f1s"], st["f1dt"]], FILTER1_COEFF)
    (jd, js), (f2dt, f2s) = _allpass4(
        [d[:, 1:T + 1], s[:, 1:T + 1]],
        [_prime4(d[:, 0], st["f2dt"], FILTER2_COEFF),
         _prime4(s[:, 0], st["f2s"], FILTER2_COEFF)], FILTER2_COEFF)

    jd = jd * _c(j_sign)
    js = js * _c(j_sign)
    w = _c(SS_W_S) * f1s_y + _c(SS_W_JD) * jd
    x = _c(SS_X_S) * f1s_y + _c(SS_X_JD) * jd
    y = _c(SS_Y_D) * f1d_y + _c(SS_Y_JS) * js
    new_st = {"f2dt": f2dt, "f1s": f1s, "f1dt": f1dt, "f2s": f2s}
    return torch.stack([w, x, y], dim=1), new_st


# --- UHJ output encoding (UhjEncoderIIR::encode, uhjfilter.cpp:231-277) ------

ENC_IIR_S_W, ENC_IIR_S_X = 0.4698463, 0.0757602682546
ENC_IIR_D_W, ENC_IIR_D_X = -0.17101005, 0.208149636675
ENC_IIR_D_Y = 0.267586995182


def uhj_encoder_iir_state(device=None) -> dict:
    z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                               device=device)
    return {"enc_f1wx": z(1, 4, 2), "enc_f2wx": z(1, 4, 2),
            "enc_f1y": z(1, 4, 2), "enc_dwx": z(1), "enc_dy": z(1)}


def uhj_encode_iir(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   st: dict, T: int):
    """FOA (W, X, Y) [T] -> (left, right, st'): the default IIR tier.

    The S and Y filter1 paths are delayed one sample relative to the
    filter2 (j) path, the mDelayWX/mDelayY alignment of
    uhjfilter.cpp:244/253; the direct-output term is zero here (the dry bus
    carries everything: no real-out prefill in this renderer)."""
    (s_f, y_f), (f1wx, f1y) = _allpass4(
        [(_c(ENC_IIR_S_W) * w + _c(ENC_IIR_S_X) * x)[None], y[None]],
        [st["enc_f1wx"], st["enc_f1y"]], FILTER1_COEFF)
    (jwx,), (f2wx,) = _allpass4(
        [(_c(ENC_IIR_D_W) * w + _c(ENC_IIR_D_X) * x)[None]],
        [st["enc_f2wx"]], FILTER2_COEFF)
    s = torch.cat([st["enc_dwx"], s_f[0][:T - 1]])
    yd = torch.cat([st["enc_dy"], y_f[0][:T - 1]])
    d = jwx[0] + _c(ENC_IIR_D_Y) * yd
    st2 = {"enc_f1wx": f1wx, "enc_f2wx": f2wx, "enc_f1y": f1y,
           "enc_dwx": s_f[0][T - 1:T], "enc_dy": y_f[0][T - 1:T]}
    return s + d, s - d, st2


# --- TSME output encoding (TsmeEncoderIIR::encode, tsmefilter.cpp:280-329) ---

TSME_S_W, TSME_S_X, TSME_S_Z = 0.288397341271, 0.166565447888, 0.187684284734
TSME_D_W, TSME_D_X = 0.444008050325, -0.256439256487
TSME_D_Y = 0.333238912931


def tsme_encoder_iir_state(device=None) -> dict:
    z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                               device=device)
    return {"tsme_f1wxz": z(1, 4, 2), "tsme_f2wx": z(1, 4, 2),
            "tsme_f1y": z(1, 4, 2), "tsme_dwxz": z(1), "tsme_dy": z(1)}


def tsme_encode_iir(w: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                    x: torch.Tensor, st: dict, T: int):
    """FOA ACN (W, Y, Z, X) [T] -> (left, right, st').

    Tetraphonic surround matrix encoding: like the UHJ encoder with the
    height (Z) folded into the S sum; the same one-sample filter1-path
    delay alignment (tsmefilter.cpp:296/305)."""
    (s_f, y_f), (f1wxz, f1y) = _allpass4(
        [(_c(TSME_S_W) * w + _c(TSME_S_X) * x + _c(TSME_S_Z) * z)[None],
         y[None]], [st["tsme_f1wxz"], st["tsme_f1y"]], FILTER1_COEFF)
    (jwx,), (f2wx,) = _allpass4(
        [(_c(TSME_D_W) * w + _c(TSME_D_X) * x)[None]], [st["tsme_f2wx"]],
        FILTER2_COEFF)
    s = torch.cat([st["tsme_dwxz"], s_f[0][:T - 1]])
    yd = torch.cat([st["tsme_dy"], y_f[0][:T - 1]])
    d = jwx[0] + _c(TSME_D_Y) * yd
    st2 = {"tsme_f1wxz": f1wxz, "tsme_f2wx": f2wx, "tsme_f1y": f1y,
           "tsme_dwxz": s_f[0][T - 1:T], "tsme_dy": y_f[0][T - 1:T]}
    return s + d, s - d, st2
