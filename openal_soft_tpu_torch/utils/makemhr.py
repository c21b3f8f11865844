"""HRTF compiler: SOFA → ``.mhr`` (utils/makemhr/makemhr.cpp analog).

The core pipeline of the reference's makemhr tool, vectorized over the IR
set in numpy (the reference fans the per-IR work over worker threads;
here each step is one batched array op):

1. onset extraction — 10x polyphase upsample, |peak| index
   (loadsofa.cpp:243-252 CalcHrirOnset)
2. magnitude responses — zero-padded forward FFT
   (loadsofa.cpp:256-263 CalcHrirMagnitude)
3. diffuse-field average with solid-angle surface weighting and a dB
   range limit, then equalization (makemhr.cpp:435-565)
4. minimum-phase reconstruction via the complex cepstrum
   (makemhr.cpp:245-262 MinimumPhase, :828-925 ReconstructHrirs)
5. max-RMS normalization with a clip guard (makemhr.cpp:927-985)
6. head-related time delays from the measured onsets (or a spherical
   head model), per-field min-subtracted, 63-sample cap
   (makemhr.cpp:989-1078)
7. MinPHR03 serialization: 24-bit TPDF-dithered samples, 2.6
   fixed-point delays, fields written farthest-first
   (makemhr.cpp:300-384 StoreMhr)

SOFA input is read with h5py (SOFA files are netCDF4-classic HDF5); the
source positions must form a complete az/elevation grid per distance —
the common measured-set layout.  ``process_hrir_set`` is the array-level
entry point for callers that already hold a gridded set.

Port of openal_soft_tpu/utils/makemhr.py (numpy only, no device work), with
one repair: ``synthesize_onsets`` blends the lower half of a synthesized
gap between the mirrored ring and the first measured ring by their
elevation angles, as makemhr.cpp:672-706 does, where the JAX package
blends from the bottom pole by the elevation index.
"""

from __future__ import annotations

import argparse
import struct

import numpy as np

from .polyphase import polyphase_resample

# makemhr.cpp:120-151 defaults
MIN_TRUNC_SIZE = 16
MAX_TRUNC_SIZE = 128
MAX_HRTD = 63.0
DEFAULT_FFT_SIZE = 65536
DEFAULT_EQUALIZE = True
DEFAULT_SURFACE = True
DEFAULT_LIMIT = 24.0
DEFAULT_TRUNC_SIZE = 64
SOFA_HEAD_RADIUS = 0.09          # loadsofa.cpp:481
ONSET_RATE_MULTIPLE = 10         # loadsofa.cpp:243
EPSILON = 1e-9


class HrirSet:
    """A gridded HRIR measurement set.

    fields: list of (distance_m, az_counts[list per elevation]) — elevations
    span -90..+90 degrees evenly (PrepareHrirData, makemhr.cpp:333-366).
    irs: [total_irs, channels, ir_size] float64, ordered field-major,
    elevation-major, azimuth-minor.  delays (seconds) same leading shape.
    """

    def __init__(self, rate: int, fields, irs: np.ndarray,
                 delays: np.ndarray | None = None,
                 radius: float = SOFA_HEAD_RADIUS,
                 ev_starts=None) -> None:
        self.rate = int(rate)
        self.fields = [(float(d), list(map(int, az))) for d, az in fields]
        # First MEASURED elevation per field (mEvStart): positions below it
        # are synthesized (SynthesizeOnsets/SynthesizeHrirs).
        self.ev_starts = list(ev_starts) if ev_starts else [0] * len(
            self.fields)
        self.irs = np.asarray(irs, np.float64)
        n, c, _ = self.irs.shape
        self.delays = (np.zeros((n, c)) if delays is None
                       else np.asarray(delays, np.float64))
        self.radius = float(radius)
        total = sum(sum(az) for _, az in self.fields)
        if total != n:
            raise ValueError(f"grid holds {total} IRs, data holds {n}")

    @property
    def channels(self) -> int:
        return self.irs.shape[1]

    def elevations(self):
        """Yields (field_idx, ev_idx, elevation_rad, az_count, ir_offset)."""
        off = 0
        for fi, (_, az_counts) in enumerate(self.fields):
            ev_n = len(az_counts)
            for ei, azn in enumerate(az_counts):
                ev = -np.pi / 2 + np.pi * ei / (ev_n - 1)
                yield fi, ei, ev, azn, off
                off += azn


def calc_onsets(hset: HrirSet) -> np.ndarray:
    """CalcHrirOnset: 10x upsample, |peak| position in seconds."""
    n, c, sz = hset.irs.shape
    flat = hset.irs.reshape(n * c, sz)
    ons = np.empty(n * c)
    for i, row in enumerate(flat):
        up = polyphase_resample(row, hset.rate,
                                ONSET_RATE_MULTIPLE * hset.rate)
        ons[i] = int(np.argmax(np.abs(up))) / (ONSET_RATE_MULTIPLE
                                               * hset.rate)
    return ons.reshape(n, c)


def calc_magnitudes(irs: np.ndarray, fft_size: int) -> np.ndarray:
    """CalcHrirMagnitude: |rfft| of the zero-padded responses."""
    return np.abs(np.fft.rfft(irs, n=fft_size, axis=-1))


def _df_weights(hset: HrirSet) -> np.ndarray:
    """CalculateDfWeights (makemhr.cpp:435-480): per-IR extruded
    solid-angle patch volumes, normalized by total solid-angle coverage."""
    n = hset.irs.shape[0]
    weights = np.zeros(n)
    sum_sa = 0.0
    inner_ra = hset.radius
    for fi, (dist, az_counts) in enumerate(hset.fields):
        if fi + 1 < len(hset.fields):
            outer_ra = 0.5 * (dist + hset.fields[fi + 1][0])
        else:
            outer_ra = 10.0
        ra_pow_diff = outer_ra ** 3 - inner_ra ** 3
        evs = np.pi / 2.0 / (len(az_counts) - 1)
        for xfi, ei, ev, azn, off in hset.elevations():
            if xfi != fi:
                continue
            if ei < hset.ev_starts[fi]:
                continue   # synthesized below mEvStart: no DFA weight
            lower = max(-np.pi / 2, ev - evs)
            upper = min(np.pi / 2, ev + evs)
            solid_angle = 2.0 * np.pi * (np.sin(upper) - np.sin(lower))
            weights[off:off + azn] = (solid_angle * ra_pow_diff / 3.0) / azn
            sum_sa += solid_angle
        inner_ra = outer_ra
    return weights / sum_sa


def _limit_magnitude(dfa: np.ndarray, fft_size: int, limit_db: float
                     ) -> np.ndarray:
    """LimitMagnitudeResponse (makemhr.cpp:215-238): clamp to ±limit/2 dB
    around the 6-octave average."""
    db = 20.0 * np.log10(dfa)
    lower = int(np.ceil(fft_size / 2.0 ** 8)) - 1
    upper = int(np.floor(fft_size / 2.0 ** 2)) - 1
    ave = db[lower:upper + 1].mean()
    half = limit_db / 2.0
    return 10.0 ** (np.clip(db, ave - half, ave + half) / 20.0)


def diffuse_field_average(hset: HrirSet, mags: np.ndarray, fft_size: int,
                          surface: bool = DEFAULT_SURFACE,
                          limit: float = DEFAULT_LIMIT) -> np.ndarray:
    """CalculateDiffuseFieldAverage: weighted power average per channel."""
    n, c, m = mags.shape
    w = _df_weights(hset) if surface else np.full(n, 1.0 / n)
    dfa = np.sqrt(np.einsum("i,icm->cm", w, mags * mags))
    dfa = np.maximum(dfa, EPSILON)
    if limit > 0.0:
        dfa = np.stack([_limit_magnitude(dfa[t], fft_size, limit)
                        for t in range(c)])
    return dfa


def minimum_phase(mags: np.ndarray, fft_size: int, points: int
                  ) -> np.ndarray:
    """MinimumPhase + inverse FFT (makemhr.cpp:245-262, :864-867):
    reconstruct min-phase time responses from half-spectrum magnitudes.

    mags: [..., fft/2+1] → [..., points] float64.
    """
    m = fft_size // 2 + 1
    full = np.concatenate([mags, mags[..., -2:0:-1]], axis=-1)
    logm = np.log(np.maximum(full, EPSILON))
    # complex_hilbert (common/alcomplex.cpp:198-215): analytic signal of
    # the log magnitude; its imaginary part is the min-phase response.
    cep = np.fft.ifft(logm, axis=-1)
    h = fft_size // 2
    cep[..., 1:h] *= 2.0
    cep[..., h + 1:] = 0.0
    phase = np.fft.fft(cep, axis=-1).imag
    full = full.copy()
    full[..., 0] = EPSILON
    spec = full * np.exp(1j * phase)
    resp = np.fft.ifft(spec, axis=-1).real
    return resp[..., :points]


def normalize_hrirs(irs: np.ndarray) -> np.ndarray:
    """NormalizeHrirs (makemhr.cpp:927-985): max-RMS factor, clip guard."""
    ir_size = irs.shape[-1]
    max_amp = np.abs(irs).max()
    max_rms = np.sqrt((irs * irs).mean(axis=-1)).max()
    factor = min(np.sqrt(1.0 / ir_size) / max_rms, 0.99 / max_amp)
    return irs * factor


def calc_hrtds(hset: HrirSet, onsets: np.ndarray, model: str = "dataset",
               radius: float = 0.0) -> np.ndarray:
    """CalculateHrtds (makemhr.cpp:989-1078): per-field min-subtracted
    sample delays, capped at 63."""
    delays = onsets.copy()
    if model == "sphere":
        rad = radius or hset.radius
        for fi, ei, ev, azn, off in hset.elevations():
            dist = hset.fields[fi][0]
            for ai in range(azn):
                az = 2.0 * np.pi * ai / azn
                for t in range(hset.channels):
                    # CalcLTD (makemhr.cpp:989-999); right ear mirrors az.
                    a = az if t == 0 else -az
                    azp = np.arcsin(np.cos(ev) * np.sin(a))
                    dlp = np.sqrt(dist * dist + rad * rad
                                  + 2.0 * dist * rad * np.sin(azp))
                    limit = np.sqrt(dist * dist - rad * rad)
                    if dlp > limit:
                        al = 0.5 * np.pi + azp
                        dlp = limit + rad * (al - np.arccos(rad / dist))
                    delays[off + ai, t] = dlp / 343.3
    elif radius > 0.0 and hset.radius > 0.0 and radius != hset.radius:
        delays = delays * (radius / hset.radius)

    off = 0
    out = np.zeros_like(delays)
    for dist, az_counts in hset.fields:
        cnt = sum(az_counts)
        fd = delays[off:off + cnt]
        out[off:off + cnt] = (fd - fd.min()) * hset.rate
        off += cnt
    if out.max() > MAX_HRTD:
        out *= MAX_HRTD / out.max()
    return out


def _tpdf_dither(samples: np.ndarray, scale: float, seed: int
                 ) -> tuple[np.ndarray, int]:
    """TpdfDither (makemhr.cpp:189-208) over interleaved samples in file
    order; returns rounded ints and the advanced LCG seed."""
    flat = samples.ravel()
    prn = np.empty(flat.size * 2, np.float64)
    s = np.uint32(seed)
    with np.errstate(over="ignore"):
        for i in range(flat.size * 2):
            s = np.uint32(s * np.uint32(96314165) + np.uint32(907633515))
            prn[i] = float(s)
    prn /= 4294967295.0
    out = np.round(flat * scale + (prn[0::2] - prn[1::2]))
    return out.reshape(samples.shape), int(s)


def store_mhr(hset: HrirSet, irs: np.ndarray, delays: np.ndarray,
              path: str) -> None:
    """StoreMhr (makemhr.cpp:300-384): MinPHR03, fields farthest-first."""
    n_chan = irs.shape[1]
    ir_size = irs.shape[2]
    chan_type = 1 if n_chan == 2 else 0
    blob = bytearray(b"MinPHR03")
    blob += struct.pack("<IBBB", hset.rate, chan_type, ir_size,
                        len(hset.fields))
    order = list(range(len(hset.fields)))[::-1]
    for fi in order:
        dist, az_counts = hset.fields[fi]
        blob += struct.pack("<HB", int(round(1000.0 * dist)), len(az_counts))
        blob += bytes(az_counts)

    field_offsets = np.cumsum([0] + [sum(az) for _, az in hset.fields])
    scale = 8388607.0
    seed = 22222
    for fi in order:
        lo, hi = field_offsets[fi], field_offsets[fi + 1]
        for i in range(lo, hi):
            # The reference dithers channel 0 over the whole IR, then
            # channel 1 (the RNG stream order matters), interleaving into
            # the output frame (makemhr.cpp:348-352).
            out = np.zeros((ir_size, n_chan))
            for t in range(n_chan):
                out[:, t], seed = _tpdf_dither(irs[i, t], scale, seed)
            vals = np.clip(out.ravel(), -scale - 1.0, scale).astype(np.int32)
            b = vals.astype("<i4").tobytes()
            # 24-bit little-endian: drop every 4th byte.
            blob += bytes(np.frombuffer(b, np.uint8).reshape(-1, 4)[:, :3]
                          .tobytes())
    for fi in order:
        lo, hi = field_offsets[fi], field_offsets[fi + 1]
        d = np.round(delays[lo:hi, :n_chan] * 4.0).astype(np.uint8)
        blob += d.tobytes()
    with open(path, "wb") as fh:
        fh.write(blob)


def process_hrir_set(hset: HrirSet, out_path: str,
                     fft_size: int = DEFAULT_FFT_SIZE,
                     equalize: bool = DEFAULT_EQUALIZE,
                     surface: bool = DEFAULT_SURFACE,
                     limit: float = DEFAULT_LIMIT,
                     trunc_size: int = DEFAULT_TRUNC_SIZE,
                     model: str = "dataset",
                     radius: float = 0.0) -> None:
    """The full makemhr pipeline over a gridded set (ProcessDefinition,
    makemhr.cpp:1141-1234, sans source loading)."""
    onsets = calc_onsets(hset)
    mags = calc_magnitudes(hset.irs, fft_size)
    if equalize:
        dfa = diffuse_field_average(hset, mags, fft_size, surface, limit)
        mags = mags / dfa[None]
    if any(hset.ev_starts):
        if model == "dataset":
            onsets = synthesize_onsets(hset, onsets)
        mags = synthesize_hrirs(hset, mags, fft_size)
    irs = minimum_phase(mags, fft_size, trunc_size)
    irs = normalize_hrirs(irs)
    delays = calc_hrtds(hset, onsets, model, radius)
    store_mhr(hset, irs, delays, out_path)


# --- SOFA input ---------------------------------------------------------------

def load_sofa(path: str) -> HrirSet:
    """Read a SOFA (netCDF4/HDF5) file whose SourcePositions form a complete
    az x elevation grid per distance (PrepareLayout, loadsofa.cpp:100-240)."""
    import h5py

    with h5py.File(path, "r") as f:
        ir = np.asarray(f["Data.IR"])                 # [M, R, N]
        pos = np.asarray(f["SourcePosition"])         # [M, 3] az/el/dist
        rate = int(np.asarray(f["Data.SamplingRate"]).ravel()[0])
    m, r, _ = ir.shape
    az = np.round(pos[:, 0], 3) % 360.0
    el = np.round(pos[:, 1], 3)
    dist = np.round(pos[:, 2], 4)

    fields = []
    index = np.empty(m, np.int64)
    cursor = 0
    order = []
    for d in sorted(set(dist)):
        sel = np.nonzero(dist == d)[0]
        ev_vals = sorted(set(el[sel]))
        az_counts = []
        for ev in ev_vals:
            esel = sel[el[sel] == ev]
            az_counts.append(len(esel))
            order.extend(esel[np.argsort(az[esel])])
        fields.append((d, az_counts))
        cursor += len(sel)
    index[:] = order
    return HrirSet(rate, fields, ir[index].astype(np.float64))


# --- HRIR definition files (.def) ---------------------------------------------
#
# The reference's loaddef.cpp compiles definition files that lay out the
# measurement grid and assign WAV/ASCII sources per (field, elevation,
# azimuth).  This implements the load-bearing subset the shipped .def
# files use (utils/MIT_KEMAR.def, CIAIR.def): the rate/type/points/
# radius/distance/azimuths metrics, `[fd?, ev, az] = src (+ src)*`
# elements, and `wave (ch)` / `ascii (fp)` source references with
# optional left/right ear tags.  Missing low elevations are synthesized
# per the reference (SynthesizeOnsets/SynthesizeHrirs).

_DEF_TOKEN = None   # lazy-compiled tokenizer


def _def_tokens(text: str):
    import re

    global _DEF_TOKEN
    if _DEF_TOKEN is None:
        _DEF_TOKEN = re.compile(
            r"\s*(?:(#[^\n]*)|(\"[^\"]*\"|\'[^\']*\')|"
            r"([A-Za-z_][A-Za-z0-9_]*)|"
            r"([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)|"
            r"([\[\]=,;:()+|]))")
    import re as _re
    ws = _re.compile(r"\s+")
    pos = 0
    while pos < len(text):
        w = ws.match(text, pos)
        if w:
            pos = w.end()
            continue
        m = _DEF_TOKEN.match(text, pos)
        if not m or m.end() == pos:
            raise ValueError(f"def parse error near: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.group(1):
            continue
        if m.group(2):
            yield ("str", m.group(2)[1:-1])
        elif m.group(3):
            yield ("ident", m.group(3))
        elif m.group(4):
            yield ("num", m.group(4))
        else:
            yield ("op", m.group(5))


class _Toks:
    def __init__(self, text):
        self.toks = list(_def_tokens(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self, kind=None, value=None):
        k, v = self.peek()
        if kind and k != kind:
            raise ValueError(f"expected {kind}, got {k} {v!r}")
        if value is not None and v != value:
            raise ValueError(f"expected {value!r}, got {v!r}")
        self.i += 1
        return v


def _read_wave_channel(path, channel: int, rate: int) -> np.ndarray:
    from ..alc.capture import _read_wav
    from ..core.devformat import FmtType, decode_to_float32

    wrate, styp, chans, arr = _read_wav(str(path))
    if wrate != rate:
        raise ValueError(f"{path}: rate {wrate} != dataset rate {rate}")
    flat = decode_to_float32(np.asarray(arr).ravel(), FmtType(styp))
    nch = 2 if chans == "stereo" else 1
    frames = flat.size // nch
    return flat[:frames * nch].reshape(frames, nch)[:, channel
                                                    ].astype(np.float64)


def _read_ascii_fp(path) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            for tok in line.replace(",", " ").replace(";", " ").split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
    return np.asarray(vals, np.float64)


def load_def(path: str) -> HrirSet:
    """Compile an HRIR definition file into a gridded set
    (loaddef.cpp:1190-1680 subset; see module section comment)."""
    import os

    base = os.path.dirname(os.path.abspath(path))
    tr = _Toks(open(path).read())

    rate = None
    points = None
    radius = SOFA_HEAD_RADIUS
    stereo = False
    distances = []
    az_fields = []
    while tr.peek()[0] == "ident":
        key = tr.next("ident").lower()
        tr.next("op", "=")
        if key == "rate":
            rate = int(float(tr.next("num")))
        elif key == "points":
            points = int(float(tr.next("num")))
        elif key == "radius":
            radius = float(tr.next("num"))
        elif key == "type":
            stereo = tr.next("ident").lower() == "stereo"
        elif key == "distance":
            distances = [float(tr.next("num"))]
            while tr.peek() == ("op", ","):
                tr.next()
                distances.append(float(tr.next("num")))
        elif key == "azimuths":
            field = [int(float(tr.next("num")))]
            az_fields = [field]
            while tr.peek()[1] in (",", ";"):
                if tr.next() == ";":
                    field = []
                    az_fields.append(field)
                field.append(int(float(tr.next("num"))))
        else:
            raise ValueError(f"unknown def metric {key!r}")
    if rate is None or points is None or not distances or not az_fields:
        raise ValueError("def header incomplete "
                         "(rate/points/distance/azimuths)")
    if len(az_fields) != len(distances):
        raise ValueError("distance/azimuths field counts differ")

    fields = list(zip(distances, az_fields))
    total = sum(sum(az) for _, az in fields)
    channels = 2 if stereo else 1
    irs = np.zeros((total, channels, points))
    seen = np.zeros(total, bool)

    def offset(fi, ei, ai):
        off = sum(sum(az) for _, az in fields[:fi])
        off += sum(fields[fi][1][:ei])
        return off + ai

    multi_field = len(fields) > 1
    while tr.peek()[0] is not None:
        tr.next("op", "[")
        fi = 0
        if multi_field:
            fi = int(float(tr.next("num")))
            tr.next("op", ",")
        ei = int(float(tr.next("num")))
        tr.next("op", ",")
        ai = int(float(tr.next("num")))
        tr.next("op", "]")
        tr.next("op", "=")
        per_ear = {0: [], 1: []}
        while True:
            fmt = tr.next("ident").lower()
            tr.next("op", "(")
            if fmt == "wave":
                ch = int(float(tr.next("num")))
                tr.next("op", ")")
                tr.next("op", ":")
                rel = tr.next("str")
                data = _read_wave_channel(os.path.join(base, rel), ch, rate)
            elif fmt == "ascii":
                et = tr.next("ident").lower()
                if et != "fp":
                    raise ValueError("only ascii(fp) sources are supported")
                tr.next("op", ")")
                tr.next("op", ":")
                rel = tr.next("str")
                data = _read_ascii_fp(os.path.join(base, rel))
            else:
                raise ValueError(f"unsupported source format {fmt!r}")
            ear = 0
            if tr.peek() == ("ident", "left"):
                tr.next()
            elif tr.peek() == ("ident", "right"):
                tr.next()
                ear = 1
            if data.size < points:
                raise ValueError(f"{rel}: {data.size} samples < points")
            per_ear[ear].append(data[:points])
            if tr.peek() == ("op", "+"):
                tr.next()
                continue
            break
        row = offset(fi, ei, ai)
        for ear, srcs in per_ear.items():
            if not srcs:
                continue
            if ear >= channels:
                raise ValueError("right-ear source in a mono set")
            irs[row, ear] = np.mean(srcs, axis=0)
        seen[row] = True

    # First measured elevation per field; everything measured above it.
    ev_starts = []
    for fi, (_, az_counts) in enumerate(fields):
        start = len(az_counts)
        off = offset(fi, 0, 0)
        for ei, azn in enumerate(az_counts):
            got = seen[off:off + azn]
            off += azn
            if got.all():
                start = min(start, ei)
            elif got.any() or ei >= start:
                raise ValueError(
                    f"sparse definition at field {fi} elevation {ei}")
        if start >= len(az_counts) or start > (len(az_counts) - 1) // 2:
            raise ValueError(f"field {fi}: too few measured elevations")
        ev_starts.append(start)
    return HrirSet(rate, fields, irs, radius=radius, ev_starts=ev_starts)


def _az_indices(azn: int, az: float):
    """CalcAzIndices: bracketing azimuth indices + blend factor."""
    f = (az % (2.0 * np.pi)) * azn / (2.0 * np.pi)
    i0 = int(f) % azn
    return i0, (i0 + 1) % azn, f - int(f)


def synthesize_onsets(hset: HrirSet, onsets: np.ndarray) -> np.ndarray:
    """SynthesizeOnsets (makemhr.cpp:586-712): fill missing low-elevation
    delays by mirroring the top hemisphere (ears swapped for stereo,
    azimuth front<->back mirrored for mono), then blend the rest of the gap
    between the lowest mirrored ring and the lowest measured one."""
    out = onsets.copy()
    stereo = hset.channels == 2
    for fi, (_, az_counts) in enumerate(hset.fields):
        ev_start = hset.ev_starts[fi]
        if ev_start <= 0:
            continue
        nev = len(az_counts)
        base = sum(sum(az) for _, az in hset.fields[:fi])

        def roff(ei):
            return base + sum(az_counts[:ei])

        def ev_lookup(ei, az, t):
            a0, a1, af = _az_indices(az_counts[ei], az)
            col = out[roff(ei):roff(ei) + az_counts[ei], t]
            return (1 - af) * col[a0] + af * col[a1]

        top = nev - 1
        if stereo:
            out[roff(0), 0] = out[roff(top) + 0, 1]
            out[roff(0), 1] = out[roff(top) + 0, 0]
        else:
            out[roff(0), 0] = out[roff(top), 0]
        half = (ev_start + 1) // 2
        for ei in range(1, half):
            mirror_ei = nev - ei - 1
            for ai in range(az_counts[ei]):
                az = 2.0 * np.pi * ai / az_counts[ei]
                if stereo:
                    out[roff(ei) + ai, 0] = ev_lookup(mirror_ei,
                                                      az + np.pi, 1)
                    out[roff(ei) + ai, 1] = ev_lookup(mirror_ei,
                                                      az + np.pi, 0)
                else:
                    out[roff(ei) + ai, 0] = ev_lookup(mirror_ei,
                                                      np.pi - az, 0)
        # Lower half of the gap: bilinear blend between the first measured
        # ring (ev_start) and the lowest mirrored ring (lowerElevFake), each
        # with its own azimuth indices, weighted by the elevation angles
        # (makemhr.cpp:666-706).
        lower = max(half, 1) - 1

        def elev(ei):
            return -np.pi / 2 + np.pi * ei / (nev - 1)

        for ei in range(max(half, 1), ev_start):
            ef = ((elev(ev_start) - elev(ei))
                  / (elev(ev_start) - elev(lower)))
            for ai in range(az_counts[ei]):
                az = 2.0 * np.pi * ai / az_counts[ei]
                a0, a1, af0 = _az_indices(az_counts[ev_start], az)
                a2, a3, af1 = _az_indices(az_counts[lower], az)
                blend = ((1.0 - ef) * (1.0 - af0), (1.0 - ef) * af0,
                         ef * (1.0 - af1), ef * af1)
                up = out[roff(ev_start):roff(ev_start) + az_counts[ev_start]]
                lo = out[roff(lower):roff(lower) + az_counts[lower]]
                for t in range(hset.channels):
                    out[roff(ei) + ai, t] = (
                        up[a0, t] * blend[0] + up[a1, t] * blend[1]
                        + lo[a2, t] * blend[2] + lo[a3, t] * blend[3])
    return out


def synthesize_hrirs(hset: HrirSet, mags: np.ndarray, fft_size: int
                     ) -> np.ndarray:
    """SynthesizeHrirs (makemhr.cpp:716-830): synthesize the bottom pole
    from the lowest measured ring (immediate-left/right response per
    ear), then blend each missing elevation between the pole and the ring
    with a body-occlusion low-pass (4 cascaded one-poles, b scaled by the
    elevation fraction; magnitude via the closed-form response)."""
    out = mags.copy()
    m = fft_size // 2 + 1
    beta = 3.5e-6 * hset.rate
    w = 2.0 * np.pi * np.arange(m) / fft_size

    def lp_mag(b):
        num = (1.0 - b) ** 4
        den = np.abs(1.0 - b * np.exp(-1j * w)) ** 4
        return num / den

    for fi, (_, az_counts) in enumerate(hset.fields):
        ev_start = hset.ev_starts[fi]
        if ev_start <= 0:
            continue
        base = sum(sum(az) for _, az in hset.fields[:fi])

        def roff(ei):
            return base + sum(az_counts[:ei])

        ring = out[roff(ev_start):roff(ev_start) + az_counts[ev_start]]
        for t in range(hset.channels):
            az = -np.pi / 2 if t == 0 else np.pi / 2
            a0, a1, af = _az_indices(az_counts[ev_start], az)
            out[roff(0), t] = (1 - af) * ring[a0, t] + af * ring[a1, t]
        for ei in range(1, ev_start):
            of = ei / ev_start
            filt = lp_mag((1.0 - of) * beta)
            for ai in range(az_counts[ei]):
                az = 2.0 * np.pi * ai / az_counts[ei]
                a0, a1, af = _az_indices(az_counts[ev_start], az)
                for t in range(hset.channels):
                    s1 = (1 - af) * ring[a0, t] + af * ring[a1, t]
                    s = (1 - of) * out[roff(0), t] + of * s1
                    out[roff(ei) + ai, t] = s * filt
        out[roff(0)] *= lp_mag(beta)[None]
    return out


def main() -> None:
    p = argparse.ArgumentParser(description="SOFA/definition-file -> mhr HRTF compiler")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--fft-size", type=int, default=DEFAULT_FFT_SIZE)
    p.add_argument("--no-equalize", action="store_true")
    p.add_argument("--no-surface", action="store_true")
    p.add_argument("--limit", type=float, default=DEFAULT_LIMIT)
    p.add_argument("--trunc", type=int, default=DEFAULT_TRUNC_SIZE)
    p.add_argument("--model", choices=("dataset", "sphere"),
                   default="dataset")
    p.add_argument("--radius", type=float, default=0.0)
    a = p.parse_args()
    hset = (load_def(a.input) if a.input.lower().endswith(".def")
            else load_sofa(a.input))
    process_hrir_set(hset, a.output, fft_size=a.fft_size,
                     equalize=not a.no_equalize, surface=not a.no_surface,
                     limit=a.limit, trunc_size=a.trunc, model=a.model,
                     radius=a.radius)
    print(f"wrote {a.output}")


if __name__ == "__main__":
    main()
