"""HRTF store, .mhr loading, HRIR selection, and the direct-HRTF decode bake.

Host-side counterpart of core/hrtf.cpp + core/hrtf_loader.cpp: parses the
MinPHR03/02 formats into dense tensors, performs the bilinear 4-HRIR blend of
HrtfStore::getCoeffs (hrtf.cpp:191-258), and bakes the B-Format→binaural
filters of DirectHrtfState::build (hrtf.cpp:264-360) from the t-design
virtual-speaker layouts of InitHrtfPanning (alc/panning.cpp:846-1138).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..constants import (
    HRIR_DELAY_FRAC_HALF,
    HRIR_DELAY_FRAC_ONE,
    HRIR_LENGTH,
    HRTF_HISTORY_LENGTH,
    MAX_AMBI_CHANNELS,
    MIN_IR_LENGTH,
)

f32 = np.float32

PASSTHRU_COEFF = f32(1.0 / np.sqrt(2.0))


@dataclasses.dataclass
class HrtfStore:
    sample_rate: int
    ir_size: int
    field_distances: np.ndarray   # [F] f32, sorted descending
    field_ev_counts: np.ndarray   # [F] int32
    elev_az_counts: np.ndarray    # [E] int32
    elev_ir_offsets: np.ndarray   # [E] int32
    coeffs: np.ndarray            # [irTotal, 128, 2] f32
    delays: np.ndarray            # [irTotal, 2] uint8 (2.6 fixed point)

    def get_coeffs(self, elevation: float, azimuth: float, distance: float,
                   spread: float) -> tuple[np.ndarray, np.ndarray]:
        """Blend 4 HRIRs for a direction (HrtfStore::getCoeffs).

        Returns (coeffs [128, 2] f32, delays [2] int32 whole samples).
        """
        dirfact = f32(1.0 - (0.5 / np.pi) * f32(spread))

        ebase = 0
        field = len(self.field_distances) - 1
        for fi in range(len(self.field_distances) - 1):
            if distance >= self.field_distances[fi]:
                field = fi
                break
            ebase += int(self.field_ev_counts[fi])

        evcount = int(self.field_ev_counts[field])
        ev0_idx, ev0_blend = _calc_ev_index(evcount, f32(elevation))
        ev1_idx = min(ev0_idx + 1, evcount - 1)
        ir0 = int(self.elev_ir_offsets[ebase + ev0_idx])
        ir1 = int(self.elev_ir_offsets[ebase + ev1_idx])
        az_n0 = int(self.elev_az_counts[ebase + ev0_idx])
        az_n1 = int(self.elev_az_counts[ebase + ev1_idx])
        az0_idx, az0_blend = _calc_az_index(az_n0, f32(azimuth))
        az1_idx, az1_blend = _calc_az_index(az_n1, f32(azimuth))

        idx = [ir0 + az0_idx, ir0 + (az0_idx + 1) % az_n0,
               ir1 + az1_idx, ir1 + (az1_idx + 1) % az_n1]
        blend = [f32((1.0 - ev0_blend) * (1.0 - az0_blend) * dirfact),
                 f32((1.0 - ev0_blend) * az0_blend * dirfact),
                 f32(ev0_blend * (1.0 - az1_blend) * dirfact),
                 f32(ev0_blend * az1_blend * dirfact)]

        delays = np.zeros(2, np.int32)
        for ear in (0, 1):
            d = f32(0.0)
            for c in range(4):
                d = f32(d + f32(self.delays[idx[c], ear]) * blend[c])
            # fastf2u: round-to-nearest-even (common/alnumeric.h:163)
            delays[ear] = int(np.rint(f32(d * f32(1.0 / HRIR_DELAY_FRAC_ONE))))

        coeffs = np.zeros((HRIR_LENGTH, 2), f32)
        coeffs[0, :] = f32(PASSTHRU_COEFF * (f32(1.0) - dirfact))
        for c in range(4):
            coeffs = (self.coeffs[idx[c]] * blend[c] + coeffs).astype(f32)
        return coeffs, delays


def _calc_ev_index(evcount: int, ev: f32) -> tuple[int, f32]:
    ev = f32((f32(1.0 / np.pi) * ev + f32(0.5)) * f32(evcount - 1))
    idx = int(max(ev, 0.0))  # float2uint truncation (negatives → 0)
    return min(idx, evcount - 1), f32(ev - f32(idx))


def _calc_az_index(azcount: int, az: f32) -> tuple[int, f32]:
    az = f32((f32(0.5 / np.pi) * az + f32(1.0)) * f32(azcount))
    idx = int(max(az, 0.0))
    return idx % azcount, f32(az - f32(idx))


def load_mhr(path: str) -> HrtfStore:
    """Parse a MinPHR02/MinPHR03 data set (core/hrtf_loader.cpp:346-721)."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic, data = data[:8], data[8:]
    if magic == b"MinPHR03":
        return _load_mhr3(data)
    if magic == b"MinPHR02":
        return _load_mhr2(data)
    if magic == b"MinPHR01":
        return _load_mhr1(data)
    if magic == b"MinPHR00":
        return _load_mhr0(data)
    raise ValueError(f"unsupported mhr format: {magic!r}")


def _read_i24_block(buf: memoryview, count: int) -> tuple[np.ndarray, memoryview]:
    raw = np.frombuffer(buf[: count * 3], np.uint8).reshape(count, 3).astype(np.int32)
    val = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
    val = (val ^ 0x800000) - 0x800000  # sign-extend 24-bit
    return (val.astype(f32) / f32(8388608.0)), buf[count * 3:]


def _load_mhr3(data: bytes) -> HrtfStore:
    buf = memoryview(data)
    rate, chan_type, ir_size, fd_count = struct.unpack_from("<IBBB", buf)
    buf = buf[7:]
    if not (MIN_IR_LENGTH <= ir_size <= HRIR_LENGTH):
        raise ValueError(f"unsupported irSize {ir_size}")

    distances, ev_counts = [], []
    az_counts: list[int] = []
    for _ in range(fd_count):
        dist_mm, ev_count = struct.unpack_from("<HB", buf)
        buf = buf[3:]
        distances.append(dist_mm / 1000.0)
        ev_counts.append(ev_count)
        az_counts.extend(buf[:ev_count])
        buf = buf[ev_count:]

    az_counts_np = np.array(az_counts, np.int32)
    ir_offsets = np.concatenate([[0], np.cumsum(az_counts_np)[:-1]]).astype(np.int32)
    ir_total = int(az_counts_np.sum())

    coeffs = np.zeros((ir_total, HRIR_LENGTH, 2), f32)
    delays = np.zeros((ir_total, 2), np.uint8)
    if chan_type == 0:  # left only, mirrored
        vals, buf = _read_i24_block(buf, ir_total * ir_size)
        coeffs[:, :ir_size, 0] = vals.reshape(ir_total, ir_size)
        ldel = np.frombuffer(buf[:ir_total], np.uint8)
        buf = buf[ir_total:]
        delays[:, 0] = ldel
        _mirror_left(az_counts_np, ir_offsets, coeffs, delays)
    elif chan_type == 1:  # left+right interleaved
        vals, buf = _read_i24_block(buf, ir_total * ir_size * 2)
        coeffs[:, :ir_size, :] = vals.reshape(ir_total, ir_size, 2)
        both = np.frombuffer(buf[: ir_total * 2], np.uint8)
        buf = buf[ir_total * 2:]
        delays[:, :] = both.reshape(ir_total, 2)
    else:
        raise ValueError(f"unsupported channel type {chan_type}")

    return HrtfStore(
        sample_rate=rate, ir_size=ir_size,
        field_distances=np.array(distances, f32),
        field_ev_counts=np.array(ev_counts, np.int32),
        elev_az_counts=az_counts_np, elev_ir_offsets=ir_offsets,
        coeffs=coeffs, delays=delays)


def _load_mhr2(data: bytes) -> HrtfStore:
    """MinPHR02: 16-bit samples, delays without the 2-bit fraction."""
    buf = memoryview(data)
    rate, sample_type, chan_type, ir_size, fd_count = struct.unpack_from("<IBBBB", buf)
    buf = buf[8:]
    distances, ev_counts = [], []
    az_counts: list[int] = []
    for _ in range(fd_count):
        dist_mm, ev_count = struct.unpack_from("<HB", buf)
        buf = buf[3:]
        distances.append(dist_mm / 1000.0)
        ev_counts.append(ev_count)
        az_counts.extend(buf[:ev_count])
        buf = buf[ev_count:]
    az_counts_np = np.array(az_counts, np.int32)
    ir_offsets = np.concatenate([[0], np.cumsum(az_counts_np)[:-1]]).astype(np.int32)
    ir_total = int(az_counts_np.sum())
    nch = 2 if chan_type == 1 else 1

    coeffs = np.zeros((ir_total, HRIR_LENGTH, 2), f32)
    delays = np.zeros((ir_total, 2), np.uint8)
    count = ir_total * ir_size * nch
    if sample_type == 0:   # 16-bit
        vals = (np.frombuffer(buf[: count * 2], "<i2").astype(f32) / f32(32768.0))
        buf = buf[count * 2:]
    else:                  # 24-bit
        vals, buf = _read_i24_block(buf, count)
    if nch == 2:
        coeffs[:, :ir_size, :] = vals.reshape(ir_total, ir_size, 2)
        both = np.frombuffer(buf[: ir_total * 2], np.uint8)
        delays[:, :] = both.reshape(ir_total, 2) << 2  # whole samples → 2.6
    else:
        coeffs[:, :ir_size, 0] = vals.reshape(ir_total, ir_size)
        delays[:, 0] = np.frombuffer(buf[:ir_total], np.uint8) << 2
        _mirror_left(az_counts_np, ir_offsets, coeffs, delays)
    return HrtfStore(
        sample_rate=rate, ir_size=ir_size,
        field_distances=np.array(distances, f32),
        field_ev_counts=np.array(ev_counts, np.int32),
        elev_az_counts=az_counts_np, elev_ir_offsets=ir_offsets,
        coeffs=coeffs, delays=delays)


def _legacy_store(rate: int, ir_size: int, az_counts_np: np.ndarray,
                  ir_offsets: np.ndarray, buf: memoryview) -> HrtfStore:
    """Shared MinPHR00/01 payload: mono 16-bit HRIRs + whole-sample delays,
    left-mirrored, one field at distance 0 (hrtf_loader.cpp:251-275,335-343)."""
    ir_total = int(az_counts_np.sum())
    coeffs = np.zeros((ir_total, HRIR_LENGTH, 2), f32)
    delays = np.zeros((ir_total, 2), np.uint8)
    count = ir_total * ir_size
    vals = np.frombuffer(buf[: count * 2], "<i2").astype(f32) / f32(32768.0)
    buf = buf[count * 2:]
    coeffs[:, :ir_size, 0] = vals.reshape(ir_total, ir_size)
    ldel = np.frombuffer(buf[:ir_total], np.uint8)
    if int(ldel.max(initial=0)) > MAX_HRIR_DELAY:
        raise ValueError("invalid HRIR delay")
    delays[:, 0] = ldel << 2                        # whole samples → 2.6
    _mirror_left(az_counts_np, ir_offsets, coeffs, delays)
    return HrtfStore(
        sample_rate=rate, ir_size=ir_size,
        field_distances=np.array([0.0], f32),
        field_ev_counts=np.array([len(az_counts_np)], np.int32),
        elev_az_counts=az_counts_np, elev_ir_offsets=ir_offsets,
        coeffs=coeffs, delays=delays)


def _load_mhr1(data: bytes) -> HrtfStore:
    """MinPHR01 (hrtf_loader.cpp:278-343): per-elevation azimuth counts."""
    buf = memoryview(data)
    rate, ir_size, ev_count = struct.unpack_from("<IBB", buf)
    buf = buf[6:]
    if not (MIN_IR_LENGTH <= ir_size <= HRIR_LENGTH):
        raise ValueError(f"unsupported irSize {ir_size}")
    az_counts_np = np.frombuffer(buf[:ev_count], np.uint8).astype(np.int32)
    buf = buf[ev_count:]
    if az_counts_np.min(initial=1) < 1 or az_counts_np.max(initial=1) > 255:
        raise ValueError("unsupported azimuth count")
    ir_offsets = np.concatenate([[0], np.cumsum(az_counts_np)[:-1]]
                                ).astype(np.int32)
    return _legacy_store(rate, ir_size, az_counts_np, ir_offsets, buf)


def _load_mhr0(data: bytes) -> HrtfStore:
    """MinPHR00 (hrtf_loader.cpp:192-276): explicit per-elevation IR offsets."""
    buf = memoryview(data)
    rate, ir_count, ir_size, ev_count = struct.unpack_from("<IHHB", buf)
    buf = buf[9:]
    if not (MIN_IR_LENGTH <= ir_size <= HRIR_LENGTH):
        raise ValueError(f"unsupported irSize {ir_size}")
    ir_offsets = np.frombuffer(buf[: ev_count * 2], "<u2").astype(np.int32)
    buf = buf[ev_count * 2:]
    if np.any(np.diff(ir_offsets) <= 0) or ir_count <= ir_offsets[-1]:
        raise ValueError("invalid evOffset")
    az_counts_np = np.diff(np.concatenate([ir_offsets, [ir_count]])
                           ).astype(np.int32)
    return _legacy_store(rate, ir_size, az_counts_np, ir_offsets, buf)


def _mirror_left(az_counts, ir_offsets, coeffs, delays) -> None:
    """Mirror left-ear responses to the right ear (hrtf_loader.cpp:135-152)."""
    for e in range(len(az_counts)):
        off, azn = int(ir_offsets[e]), int(az_counts[e])
        for j in range(azn):
            lidx = off + j
            ridx = off + ((azn - j) % azn)
            coeffs[ridx, :, 1] = coeffs[lidx, :, 0]
            delays[ridx, 1] = delays[lidx, 0]


def make_synthetic_hrtf(sample_rate: int = 48000, ir_size: int = 32) -> HrtfStore:
    """A simple spherical-head-model HRTF set for testing without data files.

    Not derived from any measured set: ITD from a Woodworth model, a one-pole
    head-shadow rolloff per azimuth.  Structure matches real stores (one
    field, elevation rows of azimuth-indexed pairs).
    """
    ev_count = 9
    az_counts = []
    for e in range(ev_count):
        elev = -90 + 180.0 * e / (ev_count - 1)
        az_counts.append(max(1, int(round(24 * np.cos(np.radians(elev))))))
    az_counts_np = np.array(az_counts, np.int32)
    ir_offsets = np.concatenate([[0], np.cumsum(az_counts_np)[:-1]]).astype(np.int32)
    ir_total = int(az_counts_np.sum())
    coeffs = np.zeros((ir_total, HRIR_LENGTH, 2), f32)
    delays = np.zeros((ir_total, 2), np.uint8)
    head_radius = 0.0875
    c_sound = 343.3
    for e in range(ev_count):
        elev = np.radians(-90 + 180.0 * e / (ev_count - 1))
        for a in range(az_counts[e]):
            az = 2 * np.pi * a / az_counts[e]
            if az > np.pi:
                az -= 2 * np.pi
            i = int(ir_offsets[e]) + a
            for ear, sign in ((0, -1.0), (1, 1.0)):
                rel = az - sign * np.pi / 2
                itd = head_radius / c_sound * (1 + abs(np.sin(rel))) * np.cos(elev)
                delay = min(itd * sample_rate, 40.0)
                shadow = 0.4 + 0.6 * (0.5 * (1 + np.cos(rel)))
                coeffs[i, 0, ear] = shadow
                coeffs[i, 1, ear] = shadow * 0.3
                delays[i, ear] = np.uint8(int(delay * HRIR_DELAY_FRAC_ONE))
    return HrtfStore(
        sample_rate=sample_rate, ir_size=ir_size,
        field_distances=np.array([1.4], f32),
        field_ev_counts=np.array([ev_count], np.int32),
        elev_az_counts=az_counts_np, elev_ir_offsets=ir_offsets,
        coeffs=coeffs, delays=delays)


# --- Direct HRTF (B-Format → binaural) bake ----------------------------------

_D35, _D45, _D135 = 6.154797087e-01, np.pi / 4, 3 * np.pi / 4
_D21, _D32, _D58 = 3.648638281e-01, 5.535743589e-01, 1.017221968e+00
_D69, _D90, _D111 = 1.205932499e+00, np.pi / 2, 1.935660155e+00
_D122, _D148, _D180 = 2.124370686e+00, 2.588018295e+00, np.pi

AMBI_POINTS_1O = [(s * _D35, a) for s in (1, -1) for a in (-_D45, -_D135, _D45, _D135)]
AMBI_MATRIX_1O = np.array([
    [0.125, 0.125, 0.125, 0.125],
    [0.125, 0.125, 0.125, -0.125],
    [0.125, -0.125, 0.125, 0.125],
    [0.125, -0.125, 0.125, -0.125],
    [0.125, 0.125, -0.125, 0.125],
    [0.125, 0.125, -0.125, -0.125],
    [0.125, -0.125, -0.125, 0.125],
    [0.125, -0.125, -0.125, -0.125]], f32)
AMBI_HF_GAIN_1O = np.array([2.0, 1.154700538], f32)

AMBI_POINTS_2O = [(-_D32, 0.0), (0.0, _D58), (_D58, _D90), (_D32, 0.0),
                  (0.0, _D122), (-_D58, -_D90), (-_D32, _D180), (0.0, -_D122),
                  (_D58, -_D90), (_D32, _D180), (0.0, -_D58), (-_D58, _D90)]
_o2 = [8.333333333e-02, 1.227808683e-01, 7.588274978e-02, 1.443375673e-01,
       1.591525047e-02, 9.316949906e-02, 1.090847495e-01, 1.167715449e-01,
       7.216878365e-02, 4.460276122e-02]
AMBI_MATRIX_2O = np.array([
    [_o2[0], 0, -_o2[2], _o2[1], 0, 0, -_o2[4], -_o2[3], _o2[7]],
    [_o2[0], -_o2[1], 0, _o2[2], -_o2[3], 0, -_o2[5], 0, -_o2[8]],
    [_o2[0], -_o2[2], _o2[1], 0, 0, -_o2[3], _o2[6], 0, -_o2[9]],
    [_o2[0], 0, _o2[2], _o2[1], 0, 0, -_o2[4], _o2[3], _o2[7]],
    [_o2[0], -_o2[1], 0, -_o2[2], _o2[3], 0, -_o2[5], 0, -_o2[8]],
    [_o2[0], _o2[2], -_o2[1], 0, 0, -_o2[3], _o2[6], 0, -_o2[9]],
    [_o2[0], 0, -_o2[2], -_o2[1], 0, 0, -_o2[4], _o2[3], _o2[7]],
    [_o2[0], _o2[1], 0, -_o2[2], -_o2[3], 0, -_o2[5], 0, -_o2[8]],
    [_o2[0], _o2[2], _o2[1], 0, 0, _o2[3], _o2[6], 0, -_o2[9]],
    [_o2[0], 0, _o2[2], -_o2[1], 0, 0, -_o2[4], -_o2[3], _o2[7]],
    [_o2[0], _o2[1], 0, _o2[2], _o2[3], 0, -_o2[5], 0, -_o2[8]],
    [_o2[0], -_o2[2], -_o2[1], 0, 0, _o2[3], _o2[6], 0, -_o2[9]]], f32)
AMBI_HF_GAIN_2O = np.array([1.825741858, 1.414213562, 7.302967433e-01], f32)

# 3rd/4th-order t-designs + decode matrices (panning.cpp:885-1041); HF gains
# use the AMP normalization rows (panning.cpp:1044-1055).
AMBI_POINTS_3O = np.array([
    [1.2059325, -1.5707964],
    [1.2059325, 1.5707964],
    [-1.2059325, -1.5707964],
    [-1.2059325, 1.5707964],
    [0.0, -1.2059325],
    [0.0, -1.9356601],
    [0.0, 1.2059325],
    [0.0, 1.9356601],
    [0.36486384, 0.0],
    [0.36486384, 3.1415927],
    [-0.36486384, 0.0],
    [-0.36486384, 3.1415927],
    [0.6154797, -0.7853982],
    [0.6154797, -2.3561945],
    [0.6154797, 0.7853982],
    [0.6154797, 2.3561945],
    [-0.6154797, -0.7853982],
    [-0.6154797, -2.3561945],
    [-0.6154797, 0.7853982],
    [-0.6154797, 2.3561945],
], f32)
AMBI_MATRIX_3O = np.array([
    [5.000000000e-02, 3.090169944e-02, 8.090169944e-02, 0.000000000e+00, 0.000000000e+00, 6.454972244e-02, 9.045084972e-02, 0.000000000e+00, -1.232790000e-02, -1.256118221e-01, 0.000000000e+00, 1.126112056e-01, 7.944389175e-02, 0.000000000e+00, 2.421151497e-02, 0.000000000e+00],
    [5.000000000e-02, -3.090169944e-02, 8.090169944e-02, 0.000000000e+00, 0.000000000e+00, -6.454972244e-02, 9.045084972e-02, 0.000000000e+00, -1.232790000e-02, 1.256118221e-01, 0.000000000e+00, -1.126112056e-01, 7.944389175e-02, 0.000000000e+00, 2.421151497e-02, 0.000000000e+00],
    [5.000000000e-02, 3.090169944e-02, -8.090169944e-02, 0.000000000e+00, 0.000000000e+00, -6.454972244e-02, 9.045084972e-02, 0.000000000e+00, -1.232790000e-02, -1.256118221e-01, 0.000000000e+00, 1.126112056e-01, -7.944389175e-02, 0.000000000e+00, -2.421151497e-02, 0.000000000e+00],
    [5.000000000e-02, -3.090169944e-02, -8.090169944e-02, 0.000000000e+00, 0.000000000e+00, 6.454972244e-02, 9.045084972e-02, 0.000000000e+00, -1.232790000e-02, 1.256118221e-01, 0.000000000e+00, -1.126112056e-01, -7.944389175e-02, 0.000000000e+00, -2.421151497e-02, 0.000000000e+00],
    [5.000000000e-02, 8.090169944e-02, 0.000000000e+00, 3.090169944e-02, 6.454972244e-02, 0.000000000e+00, -5.590169944e-02, 0.000000000e+00, -7.216878365e-02, -7.763237543e-02, 0.000000000e+00, -2.950836627e-02, 0.000000000e+00, -1.497759251e-01, 0.000000000e+00, -7.763237543e-02],
    [5.000000000e-02, 8.090169944e-02, 0.000000000e+00, -3.090169944e-02, -6.454972244e-02, 0.000000000e+00, -5.590169944e-02, 0.000000000e+00, -7.216878365e-02, -7.763237543e-02, 0.000000000e+00, -2.950836627e-02, 0.000000000e+00, 1.497759251e-01, 0.000000000e+00, 7.763237543e-02],
    [5.000000000e-02, -8.090169944e-02, 0.000000000e+00, 3.090169944e-02, -6.454972244e-02, 0.000000000e+00, -5.590169944e-02, 0.000000000e+00, -7.216878365e-02, 7.763237543e-02, 0.000000000e+00, 2.950836627e-02, 0.000000000e+00, -1.497759251e-01, 0.000000000e+00, -7.763237543e-02],
    [5.000000000e-02, -8.090169944e-02, 0.000000000e+00, -3.090169944e-02, 6.454972244e-02, 0.000000000e+00, -5.590169944e-02, 0.000000000e+00, -7.216878365e-02, 7.763237543e-02, 0.000000000e+00, 2.950836627e-02, 0.000000000e+00, 1.497759251e-01, 0.000000000e+00, 7.763237543e-02],
    [5.000000000e-02, 0.000000000e+00, 3.090169944e-02, 8.090169944e-02, 0.000000000e+00, 0.000000000e+00, -3.454915028e-02, 6.454972244e-02, 8.449668365e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 3.034486645e-02, -6.779013272e-02, 1.659481923e-01, 4.797944664e-02],
    [5.000000000e-02, 0.000000000e+00, 3.090169944e-02, -8.090169944e-02, 0.000000000e+00, 0.000000000e+00, -3.454915028e-02, -6.454972244e-02, 8.449668365e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 3.034486645e-02, 6.779013272e-02, 1.659481923e-01, -4.797944664e-02],
    [5.000000000e-02, 0.000000000e+00, -3.090169944e-02, 8.090169944e-02, 0.000000000e+00, 0.000000000e+00, -3.454915028e-02, -6.454972244e-02, 8.449668365e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.034486645e-02, -6.779013272e-02, -1.659481923e-01, 4.797944664e-02],
    [5.000000000e-02, 0.000000000e+00, -3.090169944e-02, -8.090169944e-02, 0.000000000e+00, 0.000000000e+00, -3.454915028e-02, 6.454972244e-02, 8.449668365e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.034486645e-02, 6.779013272e-02, -1.659481923e-01, -4.797944664e-02],
    [5.000000000e-02, 5.000000000e-02, 5.000000000e-02, 5.000000000e-02, 6.454972244e-02, 6.454972244e-02, 0.000000000e+00, 6.454972244e-02, 0.000000000e+00, 1.016220987e-01, 6.338656910e-02, -1.092600649e-02, -7.364853795e-02, 1.011266756e-01, -7.086833869e-02, -1.482646439e-02],
    [5.000000000e-02, 5.000000000e-02, 5.000000000e-02, -5.000000000e-02, -6.454972244e-02, 6.454972244e-02, 0.000000000e+00, -6.454972244e-02, 0.000000000e+00, 1.016220987e-01, -6.338656910e-02, -1.092600649e-02, -7.364853795e-02, -1.011266756e-01, -7.086833869e-02, 1.482646439e-02],
    [5.000000000e-02, -5.000000000e-02, 5.000000000e-02, 5.000000000e-02, -6.454972244e-02, -6.454972244e-02, 0.000000000e+00, 6.454972244e-02, 0.000000000e+00, -1.016220987e-01, -6.338656910e-02, 1.092600649e-02, -7.364853795e-02, 1.011266756e-01, -7.086833869e-02, -1.482646439e-02],
    [5.000000000e-02, -5.000000000e-02, 5.000000000e-02, -5.000000000e-02, 6.454972244e-02, -6.454972244e-02, 0.000000000e+00, -6.454972244e-02, 0.000000000e+00, -1.016220987e-01, 6.338656910e-02, 1.092600649e-02, -7.364853795e-02, -1.011266756e-01, -7.086833869e-02, 1.482646439e-02],
    [5.000000000e-02, 5.000000000e-02, -5.000000000e-02, 5.000000000e-02, 6.454972244e-02, -6.454972244e-02, 0.000000000e+00, -6.454972244e-02, 0.000000000e+00, 1.016220987e-01, -6.338656910e-02, -1.092600649e-02, 7.364853795e-02, 1.011266756e-01, 7.086833869e-02, -1.482646439e-02],
    [5.000000000e-02, 5.000000000e-02, -5.000000000e-02, -5.000000000e-02, -6.454972244e-02, -6.454972244e-02, 0.000000000e+00, 6.454972244e-02, 0.000000000e+00, 1.016220987e-01, 6.338656910e-02, -1.092600649e-02, 7.364853795e-02, -1.011266756e-01, 7.086833869e-02, 1.482646439e-02],
    [5.000000000e-02, -5.000000000e-02, -5.000000000e-02, 5.000000000e-02, -6.454972244e-02, 6.454972244e-02, 0.000000000e+00, -6.454972244e-02, 0.000000000e+00, -1.016220987e-01, 6.338656910e-02, 1.092600649e-02, 7.364853795e-02, 1.011266756e-01, 7.086833869e-02, -1.482646439e-02],
    [5.000000000e-02, -5.000000000e-02, -5.000000000e-02, -5.000000000e-02, 6.454972244e-02, 6.454972244e-02, 0.000000000e+00, 6.454972244e-02, 0.000000000e+00, -1.016220987e-01, -6.338656910e-02, 1.092600649e-02, 7.364853795e-02, -1.011266756e-01, 7.086833869e-02, 1.482646439e-02],
], f32)
AMBI_POINTS_4O = np.array([
    [1.2059325, 1.5707964],
    [1.2059325, -1.5707964],
    [1.0172219, 0.0],
    [1.0172219, 3.1415927],
    [0.6154797, 0.7853982],
    [0.6154797, 2.3561945],
    [0.6154797, -0.7853982],
    [0.6154797, -2.3561945],
    [0.5535744, 1.5707964],
    [0.5535744, -1.5707964],
    [0.36486384, 0.0],
    [0.36486384, 3.1415927],
    [0.0, 0.5535744],
    [0.0, 2.5880182],
    [0.0, -0.5535744],
    [0.0, -2.5880182],
    [0.0, 1.2059325],
    [0.0, -1.2059325],
    [0.0, 1.9356601],
    [0.0, -1.9356601],
    [-0.36486384, 0.0],
    [-0.36486384, 3.1415927],
    [-0.5535744, 1.5707964],
    [-0.5535744, -1.5707964],
    [-0.6154797, 0.7853982],
    [-0.6154797, 2.3561945],
    [-0.6154797, -0.7853982],
    [-0.6154797, -2.3561945],
    [-1.0172219, 0.0],
    [-1.0172219, 3.1415927],
    [-1.2059325, 1.5707964],
    [-1.2059325, -1.5707964],
], f32)
AMBI_MATRIX_4O = np.array([
    [3.125000000e-02, -1.931356215e-02, 5.056356215e-02, 0.000000000e+00, 0.000000000e+00, -4.149625014e-02, 5.814697482e-02, 0.000000000e+00, -7.925078574e-03, 1.522452112e-03, 0.000000000e+00, -6.187332918e-02, 5.384041069e-02, 0.000000000e+00, -2.013501509e-02, 0.000000000e+00, 0.000000000e+00, 8.560063208e-03, 0.000000000e+00, -7.899684062e-02, 4.188014710e-02, 0.000000000e+00, -3.506295521e-02, 0.000000000e+00, 1.155996975e-03],
    [3.125000000e-02, 1.931356215e-02, 5.056356215e-02, 0.000000000e+00, 0.000000000e+00, 4.149625014e-02, 5.814697482e-02, 0.000000000e+00, -7.925078574e-03, -1.522452112e-03, 0.000000000e+00, 6.187332918e-02, 5.384041069e-02, 0.000000000e+00, -2.013501509e-02, 0.000000000e+00, 0.000000000e+00, -8.560063208e-03, 0.000000000e+00, 7.899684062e-02, 4.188014710e-02, 0.000000000e+00, -3.506295521e-02, 0.000000000e+00, 1.155996975e-03],
    [3.125000000e-02, 0.000000000e+00, 4.604282561e-02, 2.845603117e-02, 0.000000000e+00, 0.000000000e+00, 3.895883912e-02, 5.154913118e-02, 1.592955758e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 2.095745091e-02, 6.719846732e-02, 3.629936978e-02, 9.158741881e-03, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -4.263013518e-03, 6.519422195e-02, 5.608172276e-02, 2.308412203e-02, 5.044065618e-03],
    [3.125000000e-02, 0.000000000e+00, 4.604282561e-02, -2.845603117e-02, 0.000000000e+00, 0.000000000e+00, 3.895883912e-02, -5.154913118e-02, 1.592955758e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 2.095745091e-02, -6.719846732e-02, 3.629936978e-02, -9.158741881e-03, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -4.263013518e-03, -6.519422195e-02, 5.608172276e-02, -2.308412203e-02, 5.044065618e-03],
    [3.125000000e-02, -3.125000000e-02, 3.125000000e-02, 3.125000000e-02, -4.149625014e-02, -4.149625014e-02, 0.000000000e+00, 4.149625014e-02, 0.000000000e+00, -2.493065047e-02, -6.338656910e-02, -2.043172564e-02, -3.222123536e-02, 1.903106711e-02, 8.858542336e-04, -2.601559590e-02, 0.000000000e+00, -4.482107285e-02, -4.791574237e-02, 1.694077318e-02, -3.750000000e-02, -1.694077318e-02, 0.000000000e+00, -4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, -3.125000000e-02, 3.125000000e-02, -3.125000000e-02, 4.149625014e-02, -4.149625014e-02, 0.000000000e+00, -4.149625014e-02, 0.000000000e+00, -2.493065047e-02, 6.338656910e-02, -2.043172564e-02, -3.222123536e-02, -1.903106711e-02, 8.858542336e-04, 2.601559590e-02, 0.000000000e+00, -4.482107285e-02, 4.791574237e-02, 1.694077318e-02, -3.750000000e-02, 1.694077318e-02, 0.000000000e+00, 4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, 3.125000000e-02, 3.125000000e-02, 3.125000000e-02, 4.149625014e-02, 4.149625014e-02, 0.000000000e+00, 4.149625014e-02, 0.000000000e+00, 2.493065047e-02, 6.338656910e-02, 2.043172564e-02, -3.222123536e-02, 1.903106711e-02, 8.858542336e-04, -2.601559590e-02, 0.000000000e+00, 4.482107285e-02, 4.791574237e-02, -1.694077318e-02, -3.750000000e-02, -1.694077318e-02, 0.000000000e+00, -4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, 3.125000000e-02, 3.125000000e-02, -3.125000000e-02, -4.149625014e-02, 4.149625014e-02, 0.000000000e+00, -4.149625014e-02, 0.000000000e+00, 2.493065047e-02, -6.338656910e-02, 2.043172564e-02, -3.222123536e-02, -1.903106711e-02, 8.858542336e-04, 2.601559590e-02, 0.000000000e+00, 4.482107285e-02, -4.791574237e-02, -1.694077318e-02, -3.750000000e-02, 1.694077318e-02, 0.000000000e+00, 4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, -4.604282561e-02, 2.845603117e-02, 0.000000000e+00, 0.000000000e+00, -5.154913118e-02, -5.684018025e-03, 0.000000000e+00, -4.170412317e-02, 3.879705320e-02, 0.000000000e+00, -1.586340627e-02, -3.390986790e-02, 0.000000000e+00, -5.873361407e-02, 0.000000000e+00, 0.000000000e+00, 6.043501607e-02, 0.000000000e+00, 3.362695493e-02, -2.921912934e-02, 0.000000000e+00, -3.376029419e-02, 0.000000000e+00, 3.457254007e-02],
    [3.125000000e-02, 4.604282561e-02, 2.845603117e-02, 0.000000000e+00, 0.000000000e+00, 5.154913118e-02, -5.684018025e-03, 0.000000000e+00, -4.170412317e-02, -3.879705320e-02, 0.000000000e+00, 1.586340627e-02, -3.390986790e-02, 0.000000000e+00, -5.873361407e-02, 0.000000000e+00, 0.000000000e+00, -6.043501607e-02, 0.000000000e+00, -3.362695493e-02, -2.921912934e-02, 0.000000000e+00, -3.376029419e-02, 0.000000000e+00, 3.457254007e-02],
    [3.125000000e-02, 0.000000000e+00, 1.931356215e-02, 5.056356215e-02, 0.000000000e+00, 0.000000000e+00, -2.221016804e-02, 4.149625014e-02, 5.431929663e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.668591722e-02, -1.705225633e-02, 4.984746936e-02, 5.489471022e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.040861381e-03, -5.358568085e-02, -5.115616222e-03, 5.867154607e-02, 5.430725099e-02],
    [3.125000000e-02, 0.000000000e+00, 1.931356215e-02, -5.056356215e-02, 0.000000000e+00, 0.000000000e+00, -2.221016804e-02, -4.149625014e-02, 5.431929663e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.668591722e-02, 1.705225633e-02, 4.984746936e-02, -5.489471022e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.040861381e-03, 5.358568085e-02, -5.115616222e-03, -5.867154607e-02, 5.430725099e-02],
    [3.125000000e-02, -2.845603117e-02, 0.000000000e+00, 4.604282561e-02, -5.154913118e-02, 0.000000000e+00, -3.327482109e-02, 0.000000000e+00, 2.577456559e-02, -6.277495073e-02, 0.000000000e+00, 2.566753052e-02, 0.000000000e+00, -4.153093679e-02, 0.000000000e+00, -5.660413777e-03, -5.282214092e-02, 0.000000000e+00, 4.464285714e-02, 0.000000000e+00, 3.348214286e-02, 0.000000000e+00, -2.232142857e-02, 0.000000000e+00, -3.961660569e-02],
    [3.125000000e-02, -2.845603117e-02, 0.000000000e+00, -4.604282561e-02, 5.154913118e-02, 0.000000000e+00, -3.327482109e-02, 0.000000000e+00, 2.577456559e-02, -6.277495073e-02, 0.000000000e+00, 2.566753052e-02, 0.000000000e+00, 4.153093679e-02, 0.000000000e+00, 5.660413777e-03, 5.282214092e-02, 0.000000000e+00, -4.464285714e-02, 0.000000000e+00, 3.348214286e-02, 0.000000000e+00, -2.232142857e-02, 0.000000000e+00, -3.961660569e-02],
    [3.125000000e-02, 2.845603117e-02, 0.000000000e+00, 4.604282561e-02, 5.154913118e-02, 0.000000000e+00, -3.327482109e-02, 0.000000000e+00, 2.577456559e-02, 6.277495073e-02, 0.000000000e+00, -2.566753052e-02, 0.000000000e+00, -4.153093679e-02, 0.000000000e+00, -5.660413777e-03, 5.282214092e-02, 0.000000000e+00, -4.464285714e-02, 0.000000000e+00, 3.348214286e-02, 0.000000000e+00, -2.232142857e-02, 0.000000000e+00, -3.961660569e-02],
    [3.125000000e-02, 2.845603117e-02, 0.000000000e+00, -4.604282561e-02, -5.154913118e-02, 0.000000000e+00, -3.327482109e-02, 0.000000000e+00, 2.577456559e-02, 6.277495073e-02, 0.000000000e+00, -2.566753052e-02, 0.000000000e+00, 4.153093679e-02, 0.000000000e+00, 5.660413777e-03, -5.282214092e-02, 0.000000000e+00, 4.464285714e-02, 0.000000000e+00, 3.348214286e-02, 0.000000000e+00, -2.232142857e-02, 0.000000000e+00, -3.961660569e-02],
    [3.125000000e-02, -5.056356215e-02, 0.000000000e+00, 1.931356215e-02, -4.149625014e-02, 0.000000000e+00, -3.593680678e-02, 0.000000000e+00, -4.639421806e-02, 3.023445375e-02, 0.000000000e+00, 4.888851054e-02, 0.000000000e+00, -1.694244021e-02, 0.000000000e+00, -5.952798034e-02, 7.086833869e-02, 0.000000000e+00, 3.593680678e-02, 0.000000000e+00, 3.616071429e-02, 0.000000000e+00, 4.017857143e-02, 0.000000000e+00, 7.923321138e-03],
    [3.125000000e-02, 5.056356215e-02, 0.000000000e+00, 1.931356215e-02, 4.149625014e-02, 0.000000000e+00, -3.593680678e-02, 0.000000000e+00, -4.639421806e-02, -3.023445375e-02, 0.000000000e+00, -4.888851054e-02, 0.000000000e+00, -1.694244021e-02, 0.000000000e+00, -5.952798034e-02, -7.086833869e-02, 0.000000000e+00, -3.593680678e-02, 0.000000000e+00, 3.616071429e-02, 0.000000000e+00, 4.017857143e-02, 0.000000000e+00, 7.923321138e-03],
    [3.125000000e-02, -5.056356215e-02, 0.000000000e+00, -1.931356215e-02, 4.149625014e-02, 0.000000000e+00, -3.593680678e-02, 0.000000000e+00, -4.639421806e-02, 3.023445375e-02, 0.000000000e+00, 4.888851054e-02, 0.000000000e+00, 1.694244021e-02, 0.000000000e+00, 5.952798034e-02, -7.086833869e-02, 0.000000000e+00, -3.593680678e-02, 0.000000000e+00, 3.616071429e-02, 0.000000000e+00, 4.017857143e-02, 0.000000000e+00, 7.923321138e-03],
    [3.125000000e-02, 5.056356215e-02, 0.000000000e+00, -1.931356215e-02, -4.149625014e-02, 0.000000000e+00, -3.593680678e-02, 0.000000000e+00, -4.639421806e-02, -3.023445375e-02, 0.000000000e+00, -4.888851054e-02, 0.000000000e+00, 1.694244021e-02, 0.000000000e+00, 5.952798034e-02, 7.086833869e-02, 0.000000000e+00, 3.593680678e-02, 0.000000000e+00, 3.616071429e-02, 0.000000000e+00, 4.017857143e-02, 0.000000000e+00, 7.923321138e-03],
    [3.125000000e-02, 0.000000000e+00, -1.931356215e-02, 5.056356215e-02, 0.000000000e+00, 0.000000000e+00, -2.221016804e-02, -4.149625014e-02, 5.431929663e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 3.668591722e-02, -1.705225633e-02, -4.984746936e-02, 5.489471022e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.040861381e-03, 5.358568085e-02, -5.115616222e-03, -5.867154607e-02, 5.430725099e-02],
    [3.125000000e-02, 0.000000000e+00, -1.931356215e-02, -5.056356215e-02, 0.000000000e+00, 0.000000000e+00, -2.221016804e-02, 4.149625014e-02, 5.431929663e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 3.668591722e-02, 1.705225633e-02, -4.984746936e-02, -5.489471022e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -3.040861381e-03, -5.358568085e-02, -5.115616222e-03, 5.867154607e-02, 5.430725099e-02],
    [3.125000000e-02, -4.604282561e-02, -2.845603117e-02, 0.000000000e+00, 0.000000000e+00, 5.154913118e-02, -5.684018025e-03, 0.000000000e+00, -4.170412317e-02, 3.879705320e-02, 0.000000000e+00, -1.586340627e-02, 3.390986790e-02, 0.000000000e+00, 5.873361407e-02, 0.000000000e+00, 0.000000000e+00, -6.043501607e-02, 0.000000000e+00, -3.362695493e-02, -2.921912934e-02, 0.000000000e+00, -3.376029419e-02, 0.000000000e+00, 3.457254007e-02],
    [3.125000000e-02, 4.604282561e-02, -2.845603117e-02, 0.000000000e+00, 0.000000000e+00, -5.154913118e-02, -5.684018025e-03, 0.000000000e+00, -4.170412317e-02, -3.879705320e-02, 0.000000000e+00, 1.586340627e-02, 3.390986790e-02, 0.000000000e+00, 5.873361407e-02, 0.000000000e+00, 0.000000000e+00, 6.043501607e-02, 0.000000000e+00, 3.362695493e-02, -2.921912934e-02, 0.000000000e+00, -3.376029419e-02, 0.000000000e+00, 3.457254007e-02],
    [3.125000000e-02, -3.125000000e-02, -3.125000000e-02, 3.125000000e-02, -4.149625014e-02, 4.149625014e-02, 0.000000000e+00, -4.149625014e-02, 0.000000000e+00, -2.493065047e-02, 6.338656910e-02, -2.043172564e-02, 3.222123536e-02, 1.903106711e-02, -8.858542336e-04, -2.601559590e-02, 0.000000000e+00, 4.482107285e-02, -4.791574237e-02, -1.694077318e-02, -3.750000000e-02, 1.694077318e-02, 0.000000000e+00, 4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, -3.125000000e-02, -3.125000000e-02, -3.125000000e-02, 4.149625014e-02, 4.149625014e-02, 0.000000000e+00, 4.149625014e-02, 0.000000000e+00, -2.493065047e-02, -6.338656910e-02, -2.043172564e-02, 3.222123536e-02, -1.903106711e-02, -8.858542336e-04, 2.601559590e-02, 0.000000000e+00, 4.482107285e-02, 4.791574237e-02, -1.694077318e-02, -3.750000000e-02, -1.694077318e-02, 0.000000000e+00, -4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, 3.125000000e-02, -3.125000000e-02, 3.125000000e-02, 4.149625014e-02, -4.149625014e-02, 0.000000000e+00, -4.149625014e-02, 0.000000000e+00, 2.493065047e-02, -6.338656910e-02, 2.043172564e-02, 3.222123536e-02, 1.903106711e-02, -8.858542336e-04, -2.601559590e-02, 0.000000000e+00, -4.482107285e-02, 4.791574237e-02, 1.694077318e-02, -3.750000000e-02, 1.694077318e-02, 0.000000000e+00, 4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, 3.125000000e-02, -3.125000000e-02, -3.125000000e-02, -4.149625014e-02, -4.149625014e-02, 0.000000000e+00, 4.149625014e-02, 0.000000000e+00, 2.493065047e-02, 6.338656910e-02, 2.043172564e-02, 3.222123536e-02, -1.903106711e-02, -8.858542336e-04, 2.601559590e-02, 0.000000000e+00, -4.482107285e-02, -4.791574237e-02, 1.694077318e-02, -3.750000000e-02, -1.694077318e-02, 0.000000000e+00, -4.482107285e-02, -3.169328455e-02],
    [3.125000000e-02, 0.000000000e+00, -4.604282561e-02, 2.845603117e-02, 0.000000000e+00, 0.000000000e+00, 3.895883912e-02, -5.154913118e-02, 1.592955758e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -2.095745091e-02, 6.719846732e-02, -3.629936978e-02, 9.158741881e-03, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -4.263013518e-03, -6.519422195e-02, 5.608172276e-02, -2.308412203e-02, 5.044065618e-03],
    [3.125000000e-02, 0.000000000e+00, -4.604282561e-02, -2.845603117e-02, 0.000000000e+00, 0.000000000e+00, 3.895883912e-02, 5.154913118e-02, 1.592955758e-02, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -2.095745091e-02, -6.719846732e-02, -3.629936978e-02, -9.158741881e-03, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, 0.000000000e+00, -4.263013518e-03, 6.519422195e-02, 5.608172276e-02, 2.308412203e-02, 5.044065618e-03],
    [3.125000000e-02, -1.931356215e-02, -5.056356215e-02, 0.000000000e+00, 0.000000000e+00, 4.149625014e-02, 5.814697482e-02, 0.000000000e+00, -7.925078574e-03, 1.522452112e-03, 0.000000000e+00, -6.187332918e-02, -5.384041069e-02, 0.000000000e+00, 2.013501509e-02, 0.000000000e+00, 0.000000000e+00, -8.560063208e-03, 0.000000000e+00, 7.899684062e-02, 4.188014710e-02, 0.000000000e+00, -3.506295521e-02, 0.000000000e+00, 1.155996975e-03],
    [3.125000000e-02, 1.931356215e-02, -5.056356215e-02, 0.000000000e+00, 0.000000000e+00, -4.149625014e-02, 5.814697482e-02, 0.000000000e+00, -7.925078574e-03, -1.522452112e-03, 0.000000000e+00, 6.187332918e-02, -5.384041069e-02, 0.000000000e+00, 2.013501509e-02, 0.000000000e+00, 0.000000000e+00, 8.560063208e-03, 0.000000000e+00, -7.899684062e-02, 4.188014710e-02, 0.000000000e+00, -3.506295521e-02, 0.000000000e+00, 1.155996975e-03],
], f32)
AMBI_HF_GAIN_3O = np.array([1.000000000e+00, 8.611363116e-01,
                            6.123336207e-01, 3.047469850e-01], f32)
AMBI_HF_GAIN_4O = np.array([1.000000000e+00, 9.061798459e-01, 7.317428698e-01,
                            5.010311710e-01, 2.457354591e-01], f32)


@dataclasses.dataclass
class DirectHrtfState:
    """Baked B-Format→binaural filters (DirectHrtfState::build)."""
    coeffs: np.ndarray      # [n_chan, 128, 2] f32
    hf_scales: np.ndarray   # [n_chan] f32
    min_delay: int
    max_delay: int
    ir_size: int


def build_direct_hrtf(hrtf: HrtfStore, ir_size: int, ambi_order: int = 1,
                      xover_freq: float = 700.0) -> DirectHrtfState:
    """Bake the virtual-speaker HRIR set into per-ambi-channel filters."""
    points, matrix, hfgain = {
        1: (AMBI_POINTS_1O, AMBI_MATRIX_1O, AMBI_HF_GAIN_1O),
        2: (AMBI_POINTS_2O, AMBI_MATRIX_2O, AMBI_HF_GAIN_2O),
        3: (AMBI_POINTS_3O, AMBI_MATRIX_3O, AMBI_HF_GAIN_3O),
        4: (AMBI_POINTS_4O, AMBI_MATRIX_4O, AMBI_HF_GAIN_4O),
    }[ambi_order]
    per_hrir_min = ambi_order >= 3   # panning.cpp:1099-1116

    from . import ambidefs

    n_chan = (ambi_order + 1) ** 2
    hf_scales = np.array([hfgain[ambidefs.ORDER_FROM_CHANNEL[i]]
                          for i in range(n_chan)], f32)

    min_delay = HRTF_HISTORY_LENGTH * HRIR_DELAY_FRAC_ONE
    max_delay = 0
    impulses = []
    for ev, az in points:
        # Nearest-field closest-HRIR pick (hrtf.cpp:292-314)
        evcount = int(hrtf.field_ev_counts[0])
        ev0_idx, ev0_blend = _calc_ev_index(evcount, f32(ev))
        ev1_idx = min(ev0_idx + 1, evcount - 1)
        ir0 = int(hrtf.elev_ir_offsets[ev0_idx])
        ir1 = int(hrtf.elev_ir_offsets[ev1_idx])
        az_n0 = int(hrtf.elev_az_counts[ev0_idx])
        az_n1 = int(hrtf.elev_az_counts[ev1_idx])
        az0_idx, az0_blend = _calc_az_index(az_n0, f32(az))
        az1_idx, az1_blend = _calc_az_index(az_n1, f32(az))
        idx = [ir0 + az0_idx, ir0 + (az0_idx + 1) % az_n0,
               ir1 + az1_idx, ir1 + (az1_idx + 1) % az_n1]
        pick = idx[int(ev0_blend >= 0.5) * 2 + int(az1_blend >= 0.5)]
        ld, rd = int(hrtf.delays[pick, 0]), int(hrtf.delays[pick, 1])
        min_delay = min(min_delay, ld, rd)
        max_delay = max(max_delay, ld, rd)
        impulses.append((hrtf.coeffs[pick], ld, rd))

    def _round_delay(d: int) -> int:
        return (d + HRIR_DELAY_FRAC_HALF) >> 2

    tmp = np.zeros((n_chan, HRIR_LENGTH, 2), np.float64)
    out_max_delay = 0
    for (hrir, ld, rd), line in zip(impulses, matrix):
        base = min(ld, rd) if per_hrir_min else min_delay
        ldel, rdel = _round_delay(ld - base), _round_delay(rd - base)
        out_max_delay = max(out_max_delay, max(ld, rd) - base)
        for c in range(n_chan):
            mult = float(line[c])
            n_l = HRIR_LENGTH - ldel
            tmp[c, ldel:, 0] += hrir[:n_l, 0].astype(np.float64) * mult
            n_r = HRIR_LENGTH - rdel
            tmp[c, rdel:, 1] += hrir[:n_r, 1].astype(np.float64) * mult

    # Expand ir_size to cover the longest delay tail (hrtf.cpp:360-362)
    ir_size_out = min(_round_delay(out_max_delay) + ir_size, HRIR_LENGTH)
    return DirectHrtfState(coeffs=tmp.astype(f32), hf_scales=hf_scales,
                           min_delay=min_delay, max_delay=out_max_delay,
                           ir_size=ir_size_out)


MAX_HRIR_DELAY = HRTF_HISTORY_LENGTH - 1   # core/hrtf.h:64


def resample_hrtf_store(store: HrtfStore, devrate: int) -> HrtfStore:
    """Resample a whole set to the device rate (hrtf.cpp:537-605).

    IRs go through the offline polyphase resampler in f64; delays scale by
    the rate ratio, shrinking the head radius if any exceeds MaxHrirDelay.
    Not bit-exact vs the reference (its PPhaseResampler's Kaiser design
    differs in transition-band parameters) but matches its structure; the
    44.1 kHz golden budget is therefore 1e-3, not 1e-5.
    """
    from ..utils.polyphase import polyphase_resample

    if store.sample_rate == devrate:
        return store

    # One batched matmul over the whole population (both ears), matching
    # the reference's fixed HrirLength in/out processing.
    flat = store.coeffs.transpose(0, 2, 1).astype(np.float64)  # [N, 2, 128]
    y = polyphase_resample(flat, store.sample_rate, devrate,
                           out_len=HRIR_LENGTH)
    new_coeffs = y.transpose(0, 2, 1).astype(f32)

    rate_scale = f32(f32(devrate) / f32(store.sample_rate))
    fdel = (np.round(store.delays.astype(f32) * rate_scale)
            / f32(HRIR_DELAY_FRAC_ONE))
    max_delay = float(fdel.max(initial=0.0))
    delay_scale = f32(HRIR_DELAY_FRAC_ONE)
    if max_delay > MAX_HRIR_DELAY:
        delay_scale = f32(delay_scale * f32(MAX_HRIR_DELAY / max_delay))
    new_delays = np.clip((fdel * delay_scale + f32(0.5)).astype(np.int32),
                         0, 255).astype(np.uint8)

    new_ir = int(min(HRIR_LENGTH, round(store.ir_size * float(rate_scale))))
    return dataclasses.replace(store, sample_rate=devrate, ir_size=new_ir,
                               coeffs=new_coeffs, delays=new_delays)


def _data_dirs() -> list[str]:
    """HRTF search paths (SearchDataFiles, core/helpers.cpp + hrtf.cpp:430)."""
    from ..alc import config as alconf
    from . import helpers

    dirs: list[str] = []
    if pathopt := alconf.config_value_str("", "hrtf-paths"):
        dirs += [q.strip() for q in pathopt.split(",") if q.strip()]
    # Shared search-path chain (ALSOFT_LOCAL_PATH, XDG dirs, shipped data).
    dirs += helpers.data_dirs("hrtf")
    return dirs


def enumerate_hrtf() -> list[tuple[str, str]]:
    """(name, path) for every .mhr on the search paths (EnumerateHrtf).

    First entry wins on duplicate names, like the reference's AddFileEntry
    de-duplication (hrtf.cpp:376-400)."""
    import os

    out: list[tuple[str, str]] = []
    seen: set[str] = set()
    for d in _data_dirs():
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for fn in names:
            if not fn.lower().endswith(".mhr"):
                continue
            name = fn[:-4]
            if name in seen:
                continue
            seen.add(name)
            out.append((name, os.path.join(d, fn)))
    return out


def find_hrtf(name: str) -> str | None:
    for n, path in enumerate_hrtf():
        if n == name:
            return path
    return None


def default_hrtf_path() -> str | None:
    import os

    from ..alc import config as alconf

    if wanted := alconf.config_value_str("", "default-hrtf"):
        if path := find_hrtf(wanted):
            return path
    sets = enumerate_hrtf()
    if sets:
        for n, path in sets:
            if n == "Default HRTF":
                return path
        return sets[0][1]
    return None


def load_hrtf(devrate: int, name: str | None = None,
              path: str | None = None) -> HrtfStore | None:
    """GetLoadedHrtf (hrtf.cpp:466-608): load + resample to the device rate."""
    p = path or (find_hrtf(name) if name else default_hrtf_path())
    if p is None:
        return None
    return resample_hrtf_store(load_mhr(p), devrate)
