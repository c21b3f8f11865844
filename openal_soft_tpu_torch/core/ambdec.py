"""AmbDec (.ambdec) preset files: parser + custom decoder construction.

Port of core/ambdec.cpp (the line/scope parser, version 3 only) and the
decoder-view construction of alc/panning.cpp:396-541 (speaker-label →
channel mapping, ACN re-indexing, per-order gains).  The resulting
CustomDecoder feeds panning.init_panning in place of a built-in layout and
carries the per-speaker distances for NFC + distance compensation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import ambidefs
from .devformat import AmbiScaling, Channel, DevFmtChannels

f32 = np.float32

AMBI_1ORDER_MASK = 0xF
AMBI_2ORDER_MASK = 0x1FF
AMBI_3ORDER_MASK = 0xFFFF
AMBI_4ORDER_MASK = 0x1FFFFFF
AMBI_PERIPHONIC_MASK = 0xFE7CE4

MAX_AMBI_CHANNELS = 25


class AmbDecError(ValueError):
    pass


@dataclasses.dataclass
class SpeakerConf:
    name: str = ""
    distance: float = 0.0
    azimuth: float = 0.0
    elevation: float = 0.0
    connection: str = ""


@dataclasses.dataclass
class AmbDecConf:
    description: str = ""
    version: int = 0
    chan_mask: int = 0
    freq_bands: int = 0
    coeff_scale: AmbiScaling | None = None
    xover_freq: float = 0.0
    xover_ratio: float = 0.0
    speakers: list[SpeakerConf] = dataclasses.field(default_factory=list)
    lf_matrix: np.ndarray | None = None   # [C, 25]
    hf_matrix: np.ndarray | None = None   # [C, 25]
    lf_order_gain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(5, f32))
    hf_order_gain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(5, f32))


def load_ambdec(path: str) -> AmbDecConf:
    """AmbDecConf::load (core/ambdec.cpp:59-294)."""
    conf = AmbDecConf()
    scope = "global"
    spk_pos = lf_pos = hf_pos = 0

    def err(linenum, msg):
        raise AmbDecError(f"{path}:{linenum}: {msg}")

    with open(path, "r", errors="replace") as fh:
        lines = fh.readlines()

    for linenum, raw in enumerate(lines, 1):
        toks = raw.split("#", 1)[0].split()
        if not toks:
            continue
        cmd, rest = toks[0], toks[1:]

        if cmd == "/}":
            if scope == "global":
                err(linenum, "Unexpected /} in global scope")
            scope = "global"
            continue

        if scope == "speakers":
            if cmd != "add_spkr":
                err(linenum, f"Unexpected speakers command: {cmd}")
            if spk_pos == len(conf.speakers):
                err(linenum, "Too many speakers specified")
            s = conf.speakers[spk_pos]
            spk_pos += 1
            vals = rest + [""] * (5 - len(rest))
            s.name = vals[0]
            s.distance = float(vals[1] or 0.0)
            s.azimuth = float(vals[2] or 0.0)
            s.elevation = float(vals[3] or 0.0)
            s.connection = vals[4]
            if not (s.distance >= 0.0 and np.isfinite(s.distance)):
                err(linenum, f"Invalid speaker {spk_pos} distance")
        elif scope in ("lfmatrix", "hfmatrix"):
            if cmd == "order_gain":
                toread = 5 if conf.chan_mask > AMBI_3ORDER_MASK else 4
                gains = (conf.lf_order_gain if scope == "lfmatrix"
                         else conf.hf_order_gain)
                for i in range(min(toread, len(rest))):
                    gains[i] = f32(rest[i])
            elif cmd == "add_row":
                mat = (conf.lf_matrix if scope == "lfmatrix"
                       else conf.hf_matrix)
                pos = lf_pos if scope == "lfmatrix" else hf_pos
                if pos == len(conf.speakers):
                    err(linenum, "Too many matrix rows specified")
                mask = conf.chan_mask
                vi = 0
                while mask:
                    idx = (mask & -mask).bit_length() - 1
                    mask &= mask - 1
                    if vi < len(rest) and idx < MAX_AMBI_CHANNELS:
                        mat[pos, idx] = f32(rest[vi])
                    vi += 1
                if scope == "lfmatrix":
                    lf_pos += 1
                else:
                    hf_pos += 1
            else:
                err(linenum, f"Unexpected matrix command: {cmd}")
        elif cmd == "/description":
            conf.description = " ".join(rest)
        elif cmd == "/version":
            if conf.version:
                err(linenum, "Duplicate version definition")
            conf.version = int(rest[0])
            if conf.version != 3:
                err(linenum, f"Unsupported version: {conf.version}")
        elif cmd == "/dec/chan_mask":
            if conf.chan_mask:
                err(linenum, "Duplicate chan_mask definition")
            conf.chan_mask = int(rest[0], 16)
            if not conf.chan_mask or conf.chan_mask > AMBI_4ORDER_MASK:
                err(linenum, f"Invalid chan_mask: {conf.chan_mask:#x}")
            if (conf.chan_mask > AMBI_3ORDER_MASK
                    and conf.coeff_scale == AmbiScaling.FUMA):
                err(linenum, "FuMa not compatible with over third-order")
        elif cmd == "/dec/freq_bands":
            if conf.freq_bands:
                err(linenum, "Duplicate freq_bands")
            conf.freq_bands = int(rest[0])
            if conf.freq_bands not in (1, 2):
                err(linenum, f"Invalid freq_bands: {conf.freq_bands}")
        elif cmd == "/dec/speakers":
            if conf.speakers:
                err(linenum, "Duplicate speakers")
            n = int(rest[0])
            if not n:
                err(linenum, f"Invalid speakers: {n}")
            conf.speakers = [SpeakerConf() for _ in range(n)]
        elif cmd == "/dec/coeff_scale":
            if conf.coeff_scale is not None:
                err(linenum, "Duplicate coeff_scale")
            scale = rest[0] if rest else ""
            try:
                conf.coeff_scale = {"n3d": AmbiScaling.N3D,
                                    "sn3d": AmbiScaling.SN3D,
                                    "fuma": AmbiScaling.FUMA}[scale]
            except KeyError:
                err(linenum, f"Unexpected coeff_scale: {scale}")
            if (conf.chan_mask > AMBI_3ORDER_MASK
                    and conf.coeff_scale == AmbiScaling.FUMA):
                err(linenum, "FuMa not compatible with over third-order")
        elif cmd == "/opt/xover_freq":
            conf.xover_freq = float(rest[0])
        elif cmd == "/opt/xover_ratio":
            conf.xover_ratio = float(rest[0])
        elif cmd in ("/opt/input_scale", "/opt/nfeff_comp", "/opt/delay_comp",
                     "/opt/level_comp"):
            pass  # unused (ambdec.cpp:224-229)
        elif cmd == "/speakers/{":
            if not conf.speakers:
                err(linenum, "Speakers defined without a count")
            scope = "speakers"
        elif cmd in ("/lfmatrix/{", "/hfmatrix/{", "/matrix/{"):
            if not conf.speakers:
                err(linenum, "Matrix defined without a speaker count")
            if not conf.chan_mask:
                err(linenum, "Matrix defined without a channel mask")
            if conf.hf_matrix is None:
                conf.hf_matrix = np.zeros((len(conf.speakers),
                                           MAX_AMBI_CHANNELS), f32)
                if conf.freq_bands == 2:
                    conf.lf_matrix = np.zeros_like(conf.hf_matrix)
            if conf.freq_bands == 1:
                if cmd != "/matrix/{":
                    err(linenum, f'Unexpected "{cmd}" for single-band')
                scope = "hfmatrix"
            else:
                if cmd == "/lfmatrix/{":
                    scope = "lfmatrix"
                elif cmd == "/hfmatrix/{":
                    scope = "hfmatrix"
                else:
                    err(linenum, f'Unexpected "{cmd}" for dual-band')
        elif cmd == "/end":
            if (spk_pos < len(conf.speakers) or hf_pos < len(conf.speakers)
                    or (conf.freq_bands == 2
                        and lf_pos < len(conf.speakers))):
                err(linenum, "Incomplete decoder definition")
            if conf.coeff_scale is None:
                err(linenum, "No coefficient scaling defined")
            return conf
        else:
            err(linenum, f"Unexpected command: {cmd}")
    raise AmbDecError(f"{path}: unexpected end of file")


@dataclasses.dataclass
class CustomDecoder:
    """DecoderView (panning.cpp:396-541): a resolved custom speaker decode."""
    order: int
    periphonic: bool
    scaling: AmbiScaling
    channels: list[Channel]
    order_gain: np.ndarray                # [5] f32
    coeffs: np.ndarray                    # [C, n_coeffs] ACN-indexed
    order_gain_lf: np.ndarray | None = None
    coeffs_lf: np.ndarray | None = None
    speaker_dists: np.ndarray | None = None   # [C] meters
    xover_freq: float = 400.0


_SPKR_NAMES = {
    "LF": Channel.FRONT_LEFT, "RF": Channel.FRONT_RIGHT,
    "CE": Channel.FRONT_CENTER, "LS": Channel.SIDE_LEFT,
    "RS": Channel.SIDE_RIGHT, "CB": Channel.BACK_CENTER,
    "LFT": Channel.TOP_FRONT_LEFT, "RFT": Channel.TOP_FRONT_RIGHT,
    "LBT": Channel.TOP_BACK_LEFT, "RBT": Channel.TOP_BACK_RIGHT,
    "LFB": Channel.BOTTOM_FRONT_LEFT, "RFB": Channel.BOTTOM_FRONT_RIGHT,
    "LBB": Channel.BOTTOM_BACK_LEFT, "RBB": Channel.BOTTOM_BACK_RIGHT,
}


def make_decoder(conf: AmbDecConf, fmt: DevFmtChannels) -> CustomDecoder:
    """MakeDecoderView (panning.cpp:396-541)."""
    order = (4 if conf.chan_mask > AMBI_3ORDER_MASK else
             3 if conf.chan_mask > AMBI_2ORDER_MASK else
             2 if conf.chan_mask > AMBI_1ORDER_MASK else 1)
    periphonic = bool(conf.chan_mask & AMBI_PERIPHONIC_MASK)
    n_coeffs = (ambidefs.channels_from_order(order) if periphonic
                else ambidefs.channels_from_order_2d(order))
    idx_map = (ambidefs.INDEX_FROM_ACN if periphonic
               else ambidefs.INDEX_FROM_ACN_2D)

    channels: list[Channel] = []
    rows, rows_lf, dists = [], [], []
    for i, spk in enumerate(conf.speakers):
        name = spk.name
        if name == "LB":
            ch = (Channel.SIDE_LEFT if fmt == DevFmtChannels.X51
                  else Channel.BACK_LEFT)
        elif name == "RB":
            ch = (Channel.SIDE_RIGHT if fmt == DevFmtChannels.X51
                  else Channel.BACK_RIGHT)
        elif name in _SPKR_NAMES:
            ch = _SPKR_NAMES[name]
        elif name.startswith("AUX") and name[3:].isdigit() \
                and int(name[3:]) < 16:
            ch = Channel(Channel.AUX0 + int(name[3:]))
        else:
            continue  # unrecognized label: skipped with an error log
        channels.append(ch)
        rows.append(conf.hf_matrix[i, [int(idx_map[d])
                                       for d in range(n_coeffs)]])
        if conf.freq_bands == 2:
            rows_lf.append(conf.lf_matrix[i, [int(idx_map[d])
                                              for d in range(n_coeffs)]])
        dists.append(spk.distance)

    return CustomDecoder(
        order=order, periphonic=periphonic, scaling=conf.coeff_scale,
        channels=channels, order_gain=conf.hf_order_gain.copy(),
        coeffs=np.asarray(rows, f32).reshape(len(channels), n_coeffs),
        order_gain_lf=(conf.lf_order_gain.copy() if conf.freq_bands == 2
                       else None),
        coeffs_lf=(np.asarray(rows_lf, f32).reshape(len(channels), n_coeffs)
                   if conf.freq_bands == 2 else None),
        speaker_dists=np.asarray(dists, f32),
        xover_freq=float(np.clip(conf.xover_freq, 100.0, 1000.0))
        if conf.xover_freq else 400.0)
