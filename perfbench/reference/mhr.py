"""A reader of OpenAL Soft's HRTF data files (``.mhr``, format ``MinPHR03``),
written from the file layout that OpenAL Soft's loader reads:

    "MinPHR03"  magic, 8 bytes
    rate        uint32 LE, the HRIRs' sample rate
    channels    uint8: 0 left ear only (the right ear mirrors it), 1 both
    ir_size     uint8: taps stored per HRIR
    fields      uint8, then per field: distance (uint16 LE, millimetres),
                elevations (uint8) and one azimuth count (uint8) each
    hrirs       per HRIR (fields, then elevations from -90 degrees up, then
                azimuths clockwise from the front): ir_size signed 24-bit
                LE samples per ear stored, over 2**23
    delays      per HRIR, one uint8 per ear stored, in quarter samples

A left-only set mirrors HRIR j of an elevation with azimuth count n into
the right ear of HRIR (n - j) % n of the same elevation.  HRIRs are kept
zero-padded to ``HRIR_LENGTH`` taps, as OpenAL Soft's store keeps them.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

HRIR_LENGTH = 128           # taps of a stored HRIR (hrtfdefs.h)
HISTORY_LENGTH = 64         # input samples a voice keeps for its delays
DELAY_FRAC_BITS = 2         # delays are stored in quarter samples
MAX_DELAY = HISTORY_LENGTH - 1


@dataclasses.dataclass
class HrirSet:
    rate: int
    ir_size: int
    field_distance: np.ndarray     # [F] metres, as stored
    field_ev_count: np.ndarray     # [F]
    az_count: np.ndarray           # [E] per elevation, fields in order
    ir_offset: np.ndarray          # [E] first HRIR of each elevation
    coeffs: np.ndarray             # [N, HRIR_LENGTH, 2] float32
    delays: np.ndarray             # [N, 2] quarter samples


def _s24(raw: bytes, count: int) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8, count * 3).reshape(count, 3)
    v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
         | (b[:, 2].astype(np.int32) << 16))
    v = np.where(v >= 1 << 23, v - (1 << 24), v)
    return (v.astype(np.float32) / np.float32(1 << 23)).astype(np.float32)


def load(path) -> HrirSet:
    data = Path(path).read_bytes()
    if data[:8] != b"MinPHR03":
        raise ValueError(f"{path}: not a MinPHR03 data set")
    rate, channels, ir_size, n_fields = struct.unpack_from("<IBBB", data, 8)
    if channels not in (0, 1) or not 8 <= ir_size <= HRIR_LENGTH:
        raise ValueError(f"{path}: channels {channels}, ir_size {ir_size}")
    p = 15
    dist, evs, azs = [], [], []
    for _ in range(n_fields):
        mm, ev = struct.unpack_from("<HB", data, p)
        dist.append(mm / 1000.0)
        evs.append(ev)
        azs += list(data[p + 3:p + 3 + ev])
        p += 3 + ev
    az = np.array(azs, np.int64)
    off = np.concatenate([[0], np.cumsum(az)[:-1]]).astype(np.int64)
    n = int(az.sum())
    ears = 2 if channels == 1 else 1
    vals = _s24(data[p:p + n * ir_size * ears * 3], n * ir_size * ears)
    p += n * ir_size * ears * 3
    dl = np.frombuffer(data, np.uint8, n * ears, p).astype(np.int64)
    if p + n * ears != len(data):
        raise ValueError(f"{path}: {len(data) - p - n * ears} bytes left over")
    if dl.max() > MAX_DELAY << DELAY_FRAC_BITS:
        raise ValueError(f"{path}: a delay over {MAX_DELAY} samples")
    coeffs = np.zeros((n, HRIR_LENGTH, 2), np.float32)
    delays = np.zeros((n, 2), np.int64)
    if ears == 2:
        coeffs[:, :ir_size, :] = vals.reshape(n, ir_size, 2)
        delays[:] = dl.reshape(n, 2)
    else:
        coeffs[:, :ir_size, 0] = vals.reshape(n, ir_size)
        delays[:, 0] = dl
        for o, cnt in zip(off, az):
            j = np.arange(cnt)
            right = o + (cnt - j) % cnt
            coeffs[right, :, 1] = coeffs[o + j, :, 0]
            delays[right, 1] = delays[o + j, 0]
    return HrirSet(rate, ir_size, np.array(dist), np.array(evs, np.int64), az,
                   off, coeffs, delays)
