"""Filters of the render path on torch tensors (port of ops/filters.py).

* ``biquad_interp``: the voices' direct and send filters (two cascaded
  TDF2 biquads per line, BiquadInterpFilter::dualProcess) and the UHJ
  codecs' four-section all-passes, with the 32-sample coefficient lerp,
  sample by sample.  It is the plain version of the Hopper kernel
  ``csrc/biquad.cu`` (``ops/kernels/biquad.py``), which repeats its
  arithmetic in the same order and equals it bit for bit.
* ``_biquad_chunked_single``: one TDF2 biquad per line in the balanced
  companion form, chunk-parallel (the reverb's band, T60 and master
  filters).  Split into its constants (``biquad_consts``) and its
  application (``biquad_apply``) so that a caller running many chunks with
  one coefficient set computes the constants once; the values are the same
  either way.  ``ops/kernels/reverb.py`` and ``csrc/reverb.cu`` repeat this
  arithmetic in the same order.
* ``linear2_chunked``: a 2-state linear filter, chunk-parallel (the NFC
  sections of ``ops/nfc.py``).
* ``band_split``, ``band_split_hf_scale`` and ``all_pass``: the sequential
  band splitter (the front stabiliser; with an HF scale, the reverb's
  first-order upmix) and the phase-matching all-pass.
* ``BandSplitterKernels``: the chunk-parallel band splitter of the dry bus
  (``split`` for the dual-band speaker decode, ``hf_scale`` for the HRTF
  decode, ``scale``).
* the host half: the biquad interpolation schedule and the band-splitter
  coefficient, in numpy.

Every elementwise expression keeps the JAX package's operand order, so the
two differ only where XLA:CPU contracts ``a + b*c`` into FMA or reorders a
contraction.
"""

from __future__ import annotations

import numpy as np
import torch

INTERP_STEPS = 8
SAMPLES_PER_STEP = 32
INTERP_SAMPLES = INTERP_STEPS * SAMPLES_PER_STEP  # 256


# --- the voices' dual biquad ---------------------------------------------------


def lerp_coeffs(cf: torch.Tensor, target: torch.Tensor, cnt: torch.Tensor):
    """End-of-step coefficient update (biquad.cpp:310-331): the counter
    drops by one step, and the current coefficients [V, 2, 5] move the
    fraction a = 1/(steps_left+1) toward their targets, or land on them when
    the counter reaches 0.  Lines whose counter was 0 keep theirs.
    Returns (cf', cnt')."""
    cnt2 = torch.clamp(cnt - SAMPLES_PER_STEP, min=0)
    steps = (cnt2 // SAMPLES_PER_STEP).to(torch.float32) + 1.0
    a = torch.ones_like(steps) / steps
    lerped = cf + (target - cf) * a[:, None, None]
    was_active = (cnt > 0)[:, None, None]
    done = (cnt2 == 0)[:, None, None]
    return torch.where(was_active, torch.where(done, target, lerped), cf), cnt2


def biquad_interp(x: torch.Tensor, z: torch.Tensor, coeffs: torch.Tensor,
                  target: torch.Tensor, counter: torch.Tensor):
    """S cascaded interpolating TDF2 biquads per line over a block, sample
    by sample (BiquadInterpFilter::dualProcess, biquad.cpp:284-343, for the
    voices' filters, S = 2; the UHJ codecs' all-pass cascades take S = 4).

    x [V, T] with T % 32 == 0; z [V, S, 2] TDF2 states ([:, section, (z1,
    z2)]); coeffs, target [V, S, 5] ([b0, b1, b2, a1, a2]); counter [V]
    int32 samples left in the interpolation (>= 0).  Every 32 samples the
    coefficients step with ``lerp_coeffs``.  Each product and sum rounds on
    its own, in the reference's TDF2 order, so S = 4 equals two S = 2 calls
    in a row from the same counter.
    Returns (y [V, T], z' [V, S, 2], coeffs' [V, S, 5], counter' [V])."""
    V, T = x.shape
    S = z.shape[1]
    if T % SAMPLES_PER_STEP:
        raise ValueError(f"biquad_interp: T={T} is not a multiple of "
                         f"{SAMPLES_PER_STEP}")
    xt = x.T.contiguous()
    zs = [(z[:, s, 0], z[:, s, 1]) for s in range(S)]
    cf, cnt = coeffs, counter
    ys = []
    for s0 in range(0, T, SAMPLES_PER_STEP):
        sec = [cf[:, s].unbind(1) for s in range(S)]
        for t in range(s0, s0 + SAMPLES_PER_STEP):
            v = xt[t]
            for s, (b0, b1, b2, a1, a2) in enumerate(sec):
                z0, z1 = zs[s]
                y = v * b0 + z0
                zs[s] = (v * b1 - y * a1 + z1, v * b2 - y * a2)
                v = y
            ys.append(v)
        cf, cnt = lerp_coeffs(cf, target, cnt)
    z2 = torch.stack([torch.stack(p, 1) for p in zs], 1)
    return torch.stack(ys, 1), z2, cf, cnt


# --- the chunked biquad -------------------------------------------------------


def biquad_consts(cf_all: torch.Tensor, chunk: int = SAMPLES_PER_STEP) -> dict:
    """Balanced-companion constants of ``_biquad_chunked_single``.

    cf_all: [N, L, 5] per-chunk coefficients (b0, b1, b2, a1, a2).  The
    similarity transform s1 -> s1/delta, delta = sqrt(|a2|) from chunk 0,
    keeps A^k near a rotation for complex pole pairs (near-DC shelves).
    Returns the per-chunk A, B, b0, A^chunk (by repeated squaring) and the
    rows C*A^k (k < chunk) of the initial-state response.
    """
    b0 = cf_all[..., 0]
    a1c, a2c = cf_all[..., 3], cf_all[..., 4]
    delta = torch.sqrt(torch.clamp(a2c[0].abs(), min=1e-8))[None, :]  # [1, L]
    A00, A01 = -a1c, delta.expand_as(a1c)
    A10, A11 = -a2c / delta, torch.zeros_like(b0)
    B0 = cf_all[..., 1] - a1c * b0
    B1 = (cf_all[..., 2] - a2c * b0) / delta
    M00, M01, M10, M11 = A00, A01, A10, A11
    for _ in range(chunk.bit_length() - 1):
        M00, M01, M10, M11 = (M00 * M00 + M01 * M10, M00 * M01 + M01 * M11,
                              M10 * M00 + M11 * M10, M10 * M01 + M11 * M11)
    w0, w1 = torch.ones_like(b0), torch.zeros_like(b0)
    ws0, ws1 = [], []
    for _ in range(chunk):
        ws0.append(w0)
        ws1.append(w1)
        w0, w1 = A00 * w0 + A10 * w1, A01 * w0 + A11 * w1
    return {"b0": b0, "A": (A00, A01, A10, A11), "B": (B0, B1),
            "M": (M00, M01, M10, M11), "delta": delta,
            "ws": (torch.stack(ws0), torch.stack(ws1)), "chunk": chunk}


def biquad_apply(x: torch.Tensor, z: torch.Tensor, k: dict):
    """Run a biquad with constants ``k`` over x [L, T] from TDF2 state z
    [L, 2].  Returns (y [L, T], z' [L, 2])."""
    L, T = x.shape
    chunk = k["chunk"]
    N = T // chunk
    b0 = k["b0"]
    A00, A01, A10, A11 = k["A"]
    B0, B1 = k["B"]
    delta = k["delta"]
    xs = x.T.reshape(N, chunk, L).transpose(0, 1)                   # [K,N,L]

    # Zero-state responses and input-driven end states, all chunks at once.
    s0 = torch.zeros((N, L), dtype=x.dtype, device=x.device)
    s1 = torch.zeros_like(s0)
    y_zero = []
    for xk in xs:
        y_zero.append(s0 + b0 * xk)
        s0, s1 = (A00 * s0 + A01 * s1 + B0 * xk,
                  A10 * s0 + A11 * s1 + B1 * xk)

    # Sequential chunk-state recurrence, starting in the balanced basis.
    M00, M01, M10, M11 = k["M"]
    c0, c1 = z[:, 0], z[:, 1] / delta[0]
    st0, st1 = [], []
    for n in range(N):
        st0.append(c0)
        st1.append(c1)
        c0, c1 = (M00[n] * c0 + M01[n] * c1 + s0[n],
                  M10[n] * c0 + M11[n] * c1 + s1[n])

    ws0, ws1 = k["ws"]                                              # [K,N,L]
    y_state = ws0 * torch.stack(st0)[None] + ws1 * torch.stack(st1)[None]
    y = (torch.stack(y_zero) + y_state).permute(2, 1, 0).reshape(L, T)
    return y, torch.stack([c0, c1 * delta[-1]], -1)


def _biquad_chunked_single(x: torch.Tensor, z: torch.Tensor,
                           cf_all: torch.Tensor, chunk: int):
    """One TDF2 biquad over [L, T] by the chunk-parallel state-space
    recurrence; cf_all [N, L, 5] per-chunk coefficients, z [L, 2].
    Returns (y [L, T], z' [L, 2])."""
    return biquad_apply(x, z, biquad_consts(cf_all, chunk))


def linear2_chunked(x: torch.Tensor, s: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    chunk: int = SAMPLES_PER_STEP):
    """2-state linear filter y = C*s + D*x, s' = A*s + B*x with per-line
    constant matrices, chunk-parallel like ``biquad_apply``.

    x [L, T]; s [L, 2]; A [L, 2, 2]; B, C [L, 2]; D [L].
    Returns (y [L, T], s' [L, 2])."""
    L, T = x.shape
    N = T // chunk
    A00, A01, A10, A11 = A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]
    B0, B1 = B[:, 0], B[:, 1]
    C0, C1 = C[:, 0], C[:, 1]
    xs = x.T.reshape(N, chunk, L).transpose(0, 1)                   # [K,N,L]

    # Zero-state responses and input-driven end states, all chunks at once.
    s0 = torch.zeros((N, L), dtype=x.dtype, device=x.device)
    s1 = torch.zeros_like(s0)
    y_zero = []
    for xk in xs:
        y_zero.append(C0 * s0 + C1 * s1 + D * xk)
        s0, s1 = (A00 * s0 + A01 * s1 + B0 * xk,
                  A10 * s0 + A11 * s1 + B1 * xk)

    # A^chunk by repeated squaring (chunk is a power of two).
    M00, M01, M10, M11 = A00, A01, A10, A11
    for _ in range(chunk.bit_length() - 1):
        M00, M01, M10, M11 = (M00 * M00 + M01 * M10, M00 * M01 + M01 * M11,
                              M10 * M00 + M11 * M10, M10 * M01 + M11 * M11)

    # Sequential chunk-state recurrence (N steps).
    c0, c1 = s[:, 0], s[:, 1]
    st0, st1 = [], []
    for n in range(N):
        st0.append(c0)
        st1.append(c1)
        c0, c1 = (M00 * c0 + M01 * c1 + s0[n],
                  M10 * c0 + M11 * c1 + s1[n])

    # Initial-state responses (C*A^k)*s_start.
    w0, w1 = C0, C1
    y_state = []
    st0, st1 = torch.stack(st0), torch.stack(st1)                   # [N,L]
    for _ in range(chunk):
        y_state.append(w0 * st0 + w1 * st1)
        w0, w1 = A00 * w0 + A10 * w1, A01 * w0 + A11 * w1
    y = (torch.stack(y_zero) + torch.stack(y_state)).permute(2, 1, 0)
    return y.reshape(L, T), torch.stack([c0, c1], -1)


# --- band splitters (core/filters/splitter.cpp) -------------------------------


def band_split(x: torch.Tensor, state: torch.Tensor, coeff):
    """BandSplitter::process, sample by sample: (hp [L, T], lp [L, T],
    state' [L, 3]); state = (lp_z1, lp_z2, ap_z1)."""
    ap = torch.as_tensor(coeff, dtype=torch.float32, device=x.device)
    lp = ap * 0.5 + 0.5
    lp_z1, lp_z2, ap_z1 = state[:, 0], state[:, 1], state[:, 2]
    hps, lps = [], []
    for xin in x.T:
        d0 = (xin - lp_z1) * lp
        lp_y0 = lp_z1 + d0
        lp_z1 = lp_y0 + d0
        d1 = (lp_y0 - lp_z2) * lp
        lp_y1 = lp_z2 + d1
        lp_z2 = lp_y1 + d1
        ap_y = xin * ap + ap_z1
        ap_z1 = xin - ap_y * ap
        hps.append(ap_y - lp_y1)
        lps.append(lp_y1)
    return (torch.stack(hps, 1), torch.stack(lps, 1),
            torch.stack([lp_z1, lp_z2, ap_z1], -1))


def all_pass(x: torch.Tensor, z1: torch.Tensor, coeff):
    """processAllPass, the phase-matching all-pass, sample by sample:
    (y [L, T], z1' [L])."""
    c = torch.as_tensor(coeff, dtype=torch.float32, device=x.device)
    ys = []
    for xin in x.T:
        y = xin * c + z1
        z1 = xin - y * c
        ys.append(y)
    return torch.stack(ys, 1), z1


def band_split_hf_scale(x: torch.Tensor, state: torch.Tensor, coeff,
                        hfscale, variant_3arg: bool = False):
    """processHfScale: scale the high band, keep the low band; the
    sample-sequential recurrence.  x [L, T], state [L, 3] = (lp_z1, lp_z2,
    ap_z1), hfscale scalar or [L].  ``variant_3arg`` reproduces the
    out-of-place variant's state update (splitter.cpp:79).
    Returns (y [L, T], state' [L, 3])."""
    ap = torch.as_tensor(coeff, dtype=torch.float32, device=x.device)
    lp = ap * 0.5 + 0.5
    hfs = torch.as_tensor(hfscale, dtype=torch.float32,
                          device=x.device).reshape(-1)
    hfs = hfs.expand(x.shape[0])
    lp_z1, lp_z2, ap_z1 = state[:, 0], state[:, 1], state[:, 2]
    ys = []
    for t in range(x.shape[1]):
        xin = x[:, t]
        d0 = (xin - lp_z1) * lp
        lp_y0 = lp_z1 + d0
        lp_z1 = lp_y0 + (d0 * lp if variant_3arg else d0)
        d1 = (lp_y0 - lp_z2) * lp
        lp_y1 = lp_z2 + d1
        lp_z2 = lp_y1 + d1
        ap_y = xin * ap + ap_z1
        ap_z1 = xin - ap_y * ap
        ys.append((ap_y - lp_y1) * hfs + lp_y1)
    return torch.stack(ys, 1), torch.stack([lp_z1, lp_z2, ap_z1], -1)


class BandSplitterKernels:
    """Chunk-parallel band splitter with precomputed (f64 -> f32) kernels.

    The splitter coefficient is fixed per device, so everything except the
    32-step chunk-state chain is a constant matrix: lower-triangular
    Toeplitz kernels for the zero-state low-pass and all-pass responses, a
    drive matrix for the chunk-end states, C*A^k rows for the initial-state
    responses, and A^K for the chunk recurrence.  State layout (lp_z1,
    lp_z2, ap_z1), as the sequential form's.
    """

    def __init__(self, coeff: float, variant_3arg: bool = False,
                 chunk: int = SAMPLES_PER_STEP):
        self.chunk = K = chunk
        apc = float(coeff)
        lpc = apc * 0.5 + 0.5
        z1g = lpc * (1.0 + lpc) if variant_3arg else 2.0 * lpc
        A = np.array([
            [1.0 - z1g, 0.0, 0.0],
            [2.0 * lpc * (1.0 - lpc), 1.0 - 2.0 * lpc, 0.0],
            [0.0, 0.0, -apc]])
        B = np.array([z1g, 2.0 * lpc * lpc, 1.0 - apc * apc])
        C_lp = np.array([lpc * (1.0 - lpc), 1.0 - lpc, 0.0])
        D_lp = lpc * lpc
        C_ap = np.array([0.0, 0.0, 1.0])
        D_ap = apc
        Apow = [np.eye(3)]
        for _ in range(K):
            Apow.append(A @ Apow[-1])
        T_lp = np.zeros((K, K))
        T_ap = np.zeros((K, K))
        for k in range(K):
            T_lp[k, k] = D_lp
            T_ap[k, k] = D_ap
            for i in range(k):
                T_lp[k, i] = C_lp @ Apow[k - 1 - i] @ B
                T_ap[k, i] = C_ap @ Apow[k - 1 - i] @ B
        G = np.stack([Apow[K - 1 - i] @ B for i in range(K)], axis=1)  # [3,K]
        self._host = {
            "T_lp": T_lp, "T_ap": T_ap, "G": G,
            "W_lp": np.stack([C_lp @ Apow[k] for k in range(K)]),       # [K,3]
            "W_ap": np.stack([C_ap @ Apow[k] for k in range(K)]),
            "M": Apow[K]}
        self._dev: dict = {}

    def _mats(self, device: torch.device) -> dict:
        mats = self._dev.get(device)
        if mats is None:
            mats = {k: torch.tensor(v.astype(np.float32), device=device)
                    for k, v in self._host.items()}
            self._dev[device] = mats
        return mats

    def _run(self, x: torch.Tensor, state: torch.Tensor):
        """Returns (lp [D, T], ap [D, T], state' [D, 3])."""
        m = self._mats(x.device)
        D, T = x.shape
        K = self.chunk
        N = T // K
        xc = x.reshape(D, N, K)
        lp_zero = torch.einsum("dnk,mk->dnm", xc, m["T_lp"])
        ap_zero = torch.einsum("dnk,mk->dnm", xc, m["T_ap"])
        drive = torch.einsum("dnk,jk->dnj", xc, m["G"])
        s = state
        starts = []
        for n in range(N):
            starts.append(s)
            s = torch.matmul(s, m["M"].T) + drive[:, n]
        s_starts = torch.stack(starts, 1)                            # [D,N,3]
        lp = lp_zero + torch.einsum("dnj,mj->dnm", s_starts, m["W_lp"])
        ap = ap_zero + torch.einsum("dnj,mj->dnm", s_starts, m["W_ap"])
        return lp.reshape(D, T), ap.reshape(D, T), s

    def split(self, x: torch.Tensor, state: torch.Tensor):
        """BandSplitter::process: (hp, lp, state')."""
        lp, ap, s = self._run(x, state)
        return ap - lp, lp, s

    def hf_scale(self, x: torch.Tensor, state: torch.Tensor, hfscale):
        """processHfScale: (ap - lp) * hf + lp.  hfscale [D]."""
        lp, ap, s = self._run(x, state)
        hf = torch.as_tensor(hfscale, dtype=torch.float32,
                             device=x.device).reshape(-1, 1)
        return (ap - lp) * hf + lp, s

    def scale(self, x: torch.Tensor, state: torch.Tensor, hfscale, lfscale):
        """processScale: separate HF and LF gains, scalars or [D]."""
        lp, ap, s = self._run(x, state)
        as_col = lambda g: torch.as_tensor(  # noqa: E731
            g, dtype=torch.float32, device=x.device).reshape(-1, 1)
        return (ap - lp) * as_col(hfscale) + lp * as_col(lfscale), s


# --- host half ----------------------------------------------------------------


def host_advance_interp(coeffs, target, counter, n: int):
    """Host-side mirror of the device coefficient schedule after ``n``
    samples: numpy f32 arrays, same lerp order as the device."""
    coeffs = coeffs.copy()
    counter = counter.copy()
    for _ in range(n // SAMPLES_PER_STEP):
        active = counter > 0
        counter = np.where(active, counter - SAMPLES_PER_STEP, 0)
        steps_left = counter // SAMPLES_PER_STEP
        a = (1.0 / (steps_left + 1.0)).astype(np.float32)
        lerped = (coeffs + (target - coeffs) * a[:, None, None]
                  ).astype(np.float32)
        coeffs = np.where(active[:, None, None],
                          np.where((counter == 0)[:, None, None], target,
                                   lerped), coeffs)
    return coeffs, counter


def band_splitter_coeff(f0norm) -> np.float32:
    """BandSplitter::init coefficient from the normalized crossover."""
    w = np.float32(2.0 * np.pi) * np.float32(min(float(f0norm), 0.49))
    cw = np.float32(np.cos(w))
    if cw > np.finfo(np.float32).eps:
        return np.float32((np.float32(np.sin(w)) - np.float32(1.0)) / cw)
    return np.float32(cw * np.float32(-0.5))
