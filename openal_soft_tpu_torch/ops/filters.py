"""Filters of the render path on torch tensors (port of ops/filters.py).

* ``_biquad_chunked_single``: one TDF2 biquad per line in the balanced
  companion form, chunk-parallel (the reverb's band, T60 and master
  filters).  Split into its constants (``biquad_consts``) and its
  application (``biquad_apply``) so that a caller running many chunks with
  one coefficient set computes the constants once; the values are the same
  either way.  ``ops/kernels/reverb.py`` and ``csrc/reverb.cu`` repeat this
  arithmetic in the same order.
* ``band_split_hf_scale``: the sequential band splitter with an HF scale
  (the reverb's first-order upmix).
* ``BandSplitterKernels.hf_scale``: the chunk-parallel band splitter of the
  HRTF dry bus.
* the host half: the biquad interpolation schedule and the band-splitter
  coefficient, in numpy.

Every elementwise expression keeps the JAX package's operand order, so the
two differ only where XLA:CPU contracts ``a + b*c`` into FMA or reorders a
contraction.  The direct and send filters (``biquad_dual_interp*``) are
ROADMAP A9.
"""

from __future__ import annotations

import numpy as np
import torch

INTERP_STEPS = 8
SAMPLES_PER_STEP = 32
INTERP_SAMPLES = INTERP_STEPS * SAMPLES_PER_STEP  # 256


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


# --- band splitters (core/filters/splitter.cpp) -------------------------------


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

    def hf_scale(self, x: torch.Tensor, state: torch.Tensor, hfscale):
        """processHfScale: (ap - lp) * hf + lp.  hfscale [D]."""
        lp, ap, s = self._run(x, state)
        hf = torch.as_tensor(hfscale, dtype=torch.float32,
                             device=x.device).reshape(-1, 1)
        return (ap - lp) * hf + lp, s


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
