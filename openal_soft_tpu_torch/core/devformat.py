"""Device/buffer formats and channel definitions (core/devformat.h).

Speaker channel labels, device channel configurations with their canonical
channel orders, sample types, and buffer (voice) channel formats with their
virtual speaker position maps (alc/alu.cpp:1473-1517).
"""

from __future__ import annotations

import enum

import numpy as np


class Channel(enum.IntEnum):
    FRONT_LEFT = 0
    FRONT_RIGHT = 1
    FRONT_CENTER = 2
    LFE = 3
    BACK_LEFT = 4
    BACK_RIGHT = 5
    BACK_CENTER = 6
    SIDE_LEFT = 7
    SIDE_RIGHT = 8
    TOP_CENTER = 9
    TOP_FRONT_LEFT = 10
    TOP_FRONT_CENTER = 11
    TOP_FRONT_RIGHT = 12
    TOP_BACK_LEFT = 13
    TOP_BACK_CENTER = 14
    TOP_BACK_RIGHT = 15
    BOTTOM_FRONT_LEFT = 16
    BOTTOM_FRONT_RIGHT = 17
    BOTTOM_BACK_LEFT = 18
    BOTTOM_BACK_RIGHT = 19
    AUX0 = 20
    AUX1 = 21
    AUX2 = 22
    AUX3 = 23
    AUX4 = 24
    AUX5 = 25
    AUX6 = 26
    AUX7 = 27
    AUX8 = 28
    AUX9 = 29
    AUX10 = 30
    AUX11 = 31
    AUX12 = 32
    AUX13 = 33
    AUX14 = 34
    AUX15 = 35
    MAX_CHANNELS = 36


class DevFmtChannels(enum.Enum):
    MONO = "mono"
    STEREO = "stereo"
    QUAD = "quad"
    X51 = "surround51"
    X61 = "surround61"
    X71 = "surround71"
    X714 = "surround714"
    X7144 = "surround7144"
    X3D71 = "surround3d71"
    AMBI3D = "ambi3d"


class DevFmtType(enum.Enum):
    BYTE = np.int8
    UBYTE = np.uint8
    SHORT = np.int16
    USHORT = np.uint16
    INT = np.int32
    UINT = np.uint32
    FLOAT = np.float32


class AmbiLayout(enum.Enum):
    FUMA = "fuma"
    ACN = "acn"


class AmbiScaling(enum.Enum):
    FUMA = "fuma"
    SN3D = "sn3d"
    N3D = "n3d"


C = Channel
# Canonical real-output channel orders per device format (devformat.h).
DEVICE_CHANNEL_ORDER: dict[DevFmtChannels, list[Channel]] = {
    DevFmtChannels.MONO: [C.FRONT_CENTER],
    DevFmtChannels.STEREO: [C.FRONT_LEFT, C.FRONT_RIGHT],
    DevFmtChannels.QUAD: [C.FRONT_LEFT, C.FRONT_RIGHT, C.BACK_LEFT, C.BACK_RIGHT],
    DevFmtChannels.X51: [C.FRONT_LEFT, C.FRONT_RIGHT, C.FRONT_CENTER, C.LFE,
                         C.SIDE_LEFT, C.SIDE_RIGHT],
    DevFmtChannels.X61: [C.FRONT_LEFT, C.FRONT_RIGHT, C.FRONT_CENTER, C.LFE,
                         C.BACK_CENTER, C.SIDE_LEFT, C.SIDE_RIGHT],
    DevFmtChannels.X71: [C.FRONT_LEFT, C.FRONT_RIGHT, C.FRONT_CENTER, C.LFE,
                         C.BACK_LEFT, C.BACK_RIGHT, C.SIDE_LEFT, C.SIDE_RIGHT],
    DevFmtChannels.X714: [C.FRONT_LEFT, C.FRONT_RIGHT, C.FRONT_CENTER, C.LFE,
                          C.BACK_LEFT, C.BACK_RIGHT, C.SIDE_LEFT, C.SIDE_RIGHT,
                          C.TOP_FRONT_LEFT, C.TOP_FRONT_RIGHT, C.TOP_BACK_LEFT,
                          C.TOP_BACK_RIGHT],
    DevFmtChannels.X7144: [C.FRONT_LEFT, C.FRONT_RIGHT, C.FRONT_CENTER, C.LFE,
                           C.BACK_LEFT, C.BACK_RIGHT, C.SIDE_LEFT, C.SIDE_RIGHT,
                           C.TOP_FRONT_LEFT, C.TOP_FRONT_RIGHT, C.TOP_BACK_LEFT,
                           C.TOP_BACK_RIGHT, C.BOTTOM_FRONT_LEFT, C.BOTTOM_FRONT_RIGHT,
                           C.BOTTOM_BACK_LEFT, C.BOTTOM_BACK_RIGHT],
    DevFmtChannels.X3D71: [C.FRONT_LEFT, C.FRONT_RIGHT, C.FRONT_CENTER, C.LFE,
                           C.AUX0, C.AUX1, C.SIDE_LEFT, C.SIDE_RIGHT],
}


class FmtChannels(enum.Enum):
    """Buffer (voice source) channel configurations (core/buffer_storage.h)."""
    MONO = "mono"
    STEREO = "stereo"
    REAR = "rear"
    QUAD = "quad"
    X51 = "x51"
    X61 = "x61"
    X71 = "x71"
    BFORMAT2D = "bformat2d"
    BFORMAT3D = "bformat3d"
    UHJ2 = "uhj2"
    UHJ3 = "uhj3"
    UHJ4 = "uhj4"
    SUPER_STEREO = "superstereo"


class FmtType(enum.Enum):
    """Buffer sample types (core/storage_formats.h:9-19)."""
    UBYTE = "uint8"
    SHORT = "int16"
    INT = "int32"
    FLOAT = "float32"
    DOUBLE = "float64"
    MULAW = "mulaw"
    ALAW = "alaw"
    IMA4 = "ima4"
    MSADPCM = "msadpcm"


def channels_from_fmt(fmt: FmtChannels, ambi_order: int = 0) -> int:
    """Buffer channel count (storage_formats.cpp ChannelsFromFmt)."""
    table = {
        FmtChannels.MONO: 1, FmtChannels.STEREO: 2, FmtChannels.REAR: 2,
        FmtChannels.QUAD: 4, FmtChannels.X51: 6, FmtChannels.X61: 7,
        FmtChannels.X71: 8, FmtChannels.UHJ2: 2, FmtChannels.UHJ3: 3,
        FmtChannels.UHJ4: 4, FmtChannels.SUPER_STEREO: 2,
    }
    if fmt == FmtChannels.BFORMAT2D:
        return ambi_order * 2 + 1
    if fmt == FmtChannels.BFORMAT3D:
        return (ambi_order + 1) * (ambi_order + 1)
    return table[fmt]


def is_ambisonic(fmt: FmtChannels) -> bool:
    return fmt in (FmtChannels.BFORMAT2D, FmtChannels.BFORMAT3D, FmtChannels.UHJ2,
                   FmtChannels.UHJ3, FmtChannels.UHJ4, FmtChannels.SUPER_STEREO)


def is_uhj(fmt: FmtChannels) -> bool:
    return fmt in (FmtChannels.UHJ2, FmtChannels.UHJ3, FmtChannels.UHJ4)


# Virtual speaker position maps for multichannel voices (alu.cpp:1473-1517).
# Positions are OpenAL-space unit vectors (x right, y up, z back).
_SIN30, _COS30 = 0.5, np.sqrt(3.0) / 2.0
_SIN45 = _COS45 = np.sqrt(2.0) / 2.0
_SIN110, _COS110 = np.sin(np.radians(110.0)), np.cos(np.radians(110.0))

CHAN_POS_MAPS: dict[FmtChannels, list[tuple[Channel, tuple[float, float, float]]]] = {
    FmtChannels.MONO: [(C.FRONT_CENTER, (0.0, 0.0, -1.0))],
    FmtChannels.STEREO: [(C.FRONT_LEFT, (-_SIN30, 0.0, -_COS30)),
                         (C.FRONT_RIGHT, (_SIN30, 0.0, -_COS30))],
    FmtChannels.REAR: [(C.BACK_LEFT, (-_SIN30, 0.0, _COS30)),
                       (C.BACK_RIGHT, (_SIN30, 0.0, _COS30))],
    FmtChannels.QUAD: [(C.FRONT_LEFT, (-_SIN45, 0.0, -_COS45)),
                       (C.FRONT_RIGHT, (_SIN45, 0.0, -_COS45)),
                       (C.BACK_LEFT, (-_SIN45, 0.0, _COS45)),
                       (C.BACK_RIGHT, (_SIN45, 0.0, _COS45))],
    FmtChannels.X51: [(C.FRONT_LEFT, (-_SIN30, 0.0, -_COS30)),
                      (C.FRONT_RIGHT, (_SIN30, 0.0, -_COS30)),
                      (C.FRONT_CENTER, (0.0, 0.0, -1.0)),
                      (C.LFE, (0.0, 0.0, 0.0)),
                      (C.SIDE_LEFT, (-_SIN110, 0.0, -_COS110)),
                      (C.SIDE_RIGHT, (_SIN110, 0.0, -_COS110))],
    FmtChannels.X61: [(C.FRONT_LEFT, (-_SIN30, 0.0, -_COS30)),
                      (C.FRONT_RIGHT, (_SIN30, 0.0, -_COS30)),
                      (C.FRONT_CENTER, (0.0, 0.0, -1.0)),
                      (C.LFE, (0.0, 0.0, 0.0)),
                      (C.BACK_CENTER, (0.0, 0.0, 1.0)),
                      (C.SIDE_LEFT, (-1.0, 0.0, 0.0)),
                      (C.SIDE_RIGHT, (1.0, 0.0, 0.0))],
    FmtChannels.X71: [(C.FRONT_LEFT, (-_SIN30, 0.0, -_COS30)),
                      (C.FRONT_RIGHT, (_SIN30, 0.0, -_COS30)),
                      (C.FRONT_CENTER, (0.0, 0.0, -1.0)),
                      (C.LFE, (0.0, 0.0, 0.0)),
                      (C.BACK_LEFT, (-_SIN30, 0.0, _COS30)),
                      (C.BACK_RIGHT, (_SIN30, 0.0, _COS30)),
                      (C.SIDE_LEFT, (-1.0, 0.0, 0.0)),
                      (C.SIDE_RIGHT, (1.0, 0.0, 0.0))],
}

_NP_FMT = {
    FmtType.UBYTE: np.uint8, FmtType.SHORT: np.int16, FmtType.INT: np.int32,
    FmtType.FLOAT: np.float32, FmtType.DOUBLE: np.float64,
}


def decode_to_float32(data: np.ndarray, fmt: FmtType) -> np.ndarray:
    """Sample-type conversion to float32 on upload (core/fmt_traits.h).

    Integer types map to [-1, 1) by dividing the type's positive range+1;
    unsigned types are offset-binary.  (ADPCM block formats are decoded by
    al/buffer.py before reaching here.)
    """
    if fmt == FmtType.FLOAT:
        return data.astype(np.float32)
    if fmt == FmtType.DOUBLE:
        return data.astype(np.float32)
    if fmt == FmtType.UBYTE:
        return ((data.astype(np.float32) - 128.0) * np.float32(1.0 / 128.0)).astype(np.float32)
    if fmt == FmtType.SHORT:
        return (data.astype(np.float32) * np.float32(1.0 / 32768.0)).astype(np.float32)
    if fmt == FmtType.INT:
        return (data.astype(np.float32) * np.float32(1.0 / 2147483648.0)).astype(np.float32)
    if fmt == FmtType.MULAW:
        return _mulaw_table()[data.astype(np.int64)]
    if fmt == FmtType.ALAW:
        return _alaw_table()[data.astype(np.int64)]
    raise ValueError(f"decode_to_float32 does not handle {fmt}")


def _mulaw_table() -> np.ndarray:
    """mu-law byte → f32 (core/fmt_traits.h muLawDecompressionTable semantics)."""
    i = np.arange(256)
    mu = ~i & 0xFF
    sign = mu & 0x80
    exponent = (mu >> 4) & 0x07
    mantissa = mu & 0x0F
    sample = ((mantissa << 3) + 0x84) << exponent
    sample = sample - 0x84
    sample = np.where(sign, -sample, sample)
    return (sample.astype(np.float32) / 32768.0).astype(np.float32)


def _alaw_table() -> np.ndarray:
    """a-law byte → f32."""
    i = np.arange(256)
    a = i ^ 0x55
    sign = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = a & 0x0F
    sample = np.where(exponent > 0,
                      ((mantissa << 4) + 0x108) << (exponent - 1),
                      (mantissa << 4) + 8)
    sample = np.where(sign, -sample, sample)
    return (sample.astype(np.float32) / 32768.0).astype(np.float32)
