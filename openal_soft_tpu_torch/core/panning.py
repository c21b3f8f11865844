"""Output renderer initialization and panning math.

Covers the responsibilities of alc/panning.cpp (built-in speaker decoder
configs, InitPanning) and the direction-warping helpers of alc/alu.cpp
(ScaleAzimuthFront3/ScaleAzimuthFront3_2, the pan-gain selector).  The
product of initialization is a small immutable ``RendererLayout`` the render
graph builder consumes: the dry (ambisonic) bus channel map + scales, the
B-Format→speaker decode matrices, and the render mode.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from ..constants import MAX_AMBI_CHANNELS
from . import ambidefs
from .devformat import (
    DEVICE_CHANNEL_ORDER,
    AmbiLayout,
    AmbiScaling,
    Channel,
    DevFmtChannels,
)

f32 = np.float32


class RenderMode(enum.Enum):
    NORMAL = "normal"
    PAIRWISE = "pairwise"
    HRTF = "hrtf"


@dataclasses.dataclass
class DecoderConfig:
    """A built-in speaker decoder preset (alc/panning.cpp:542-710)."""
    order: int
    periphonic: bool
    channels: list[Channel]
    scaling: AmbiScaling
    order_gain: np.ndarray          # [order+1]
    coeffs: np.ndarray              # [n_spk, n_coeffs(2D compact)]
    order_gain_lf: np.ndarray | None = None
    coeffs_lf: np.ndarray | None = None


C = Channel

MONO_CONFIG = DecoderConfig(
    0, False, [C.FRONT_CENTER], AmbiScaling.N3D,
    np.array([1.0], f32), np.array([[1.0]], f32))

STEREO_CONFIG = DecoderConfig(
    1, False, [C.FRONT_LEFT, C.FRONT_RIGHT], AmbiScaling.N3D,
    np.array([1.0, 1.0], f32),
    np.array([[5.00000000e-1, 2.88675135e-1, 5.52305643e-2],
              [5.00000000e-1, -2.88675135e-1, 5.52305643e-2]], f32))

QUAD_CONFIG = DecoderConfig(
    1, False, [C.BACK_LEFT, C.FRONT_LEFT, C.FRONT_RIGHT, C.BACK_RIGHT], AmbiScaling.N3D,
    np.array([1.41421356, 1.0], f32),
    np.array([[2.5e-1, 2.04124145e-1, -2.04124145e-1],
              [2.5e-1, 2.04124145e-1, 2.04124145e-1],
              [2.5e-1, -2.04124145e-1, 2.04124145e-1],
              [2.5e-1, -2.04124145e-1, -2.04124145e-1]], f32),
    np.array([1.0, 1.0], f32),
    np.array([[2.5e-1, 2.04124145e-1, -2.04124145e-1],
              [2.5e-1, 2.04124145e-1, 2.04124145e-1],
              [2.5e-1, -2.04124145e-1, 2.04124145e-1],
              [2.5e-1, -2.04124145e-1, -2.04124145e-1]], f32))

X51_CONFIG = DecoderConfig(
    2, False, [C.SIDE_LEFT, C.FRONT_LEFT, C.FRONT_CENTER, C.FRONT_RIGHT, C.SIDE_RIGHT],
    AmbiScaling.FUMA,
    np.array([1.0, 1.0, 1.0], f32),
    np.array([
        [5.67316000e-1, 4.22920000e-1, -3.15495000e-1, -6.34490000e-2, -2.92380000e-2],
        [3.68584000e-1, 2.72349000e-1, 3.21616000e-1, 1.92645000e-1, 4.82600000e-2],
        [1.83579000e-1, 0.0, 1.99588000e-1, 0.0, 9.62820000e-2],
        [3.68584000e-1, -2.72349000e-1, 3.21616000e-1, -1.92645000e-1, 4.82600000e-2],
        [5.67316000e-1, -4.22920000e-1, -3.15495000e-1, 6.34490000e-2, -2.92380000e-2]], f32),
    np.array([1.0, 1.0, 1.0], f32),
    np.array([
        [4.90109850e-1, 3.77305010e-1, -3.73106990e-1, -1.25914530e-1, 1.45133000e-2],
        [1.49085730e-1, 3.03561680e-1, 1.53290060e-1, 2.45112480e-1, -1.50753130e-1],
        [1.37654920e-1, 0.0, 4.49417940e-1, 0.0, 2.57844070e-1],
        [1.49085730e-1, -3.03561680e-1, 1.53290060e-1, -2.45112480e-1, -1.50753130e-1],
        [4.90109850e-1, -3.77305010e-1, -3.73106990e-1, 1.25914530e-1, 1.45133000e-2]], f32))

X61_CONFIG = DecoderConfig(
    2, False, [C.SIDE_LEFT, C.FRONT_LEFT, C.FRONT_RIGHT, C.SIDE_RIGHT, C.BACK_CENTER],
    AmbiScaling.N3D,
    np.array([1.0, 1.0, 1.0], f32),
    np.array([
        [2.04460341e-1, 2.17177926e-1, -4.39996780e-2, -2.60790269e-2, -6.87239792e-2],
        [1.58923161e-1, 9.21772680e-2, 1.59658796e-1, 6.66278083e-2, 3.84686854e-2],
        [1.58923161e-1, -9.21772680e-2, 1.59658796e-1, -6.66278083e-2, 3.84686854e-2],
        [2.04460341e-1, -2.17177926e-1, -4.39996780e-2, 2.60790269e-2, -6.87239792e-2],
        [2.50001688e-1, 0.0, -2.50000094e-1, 0.0, 6.05133395e-2]], f32))

X71_CONFIG = DecoderConfig(
    2, False, [C.BACK_LEFT, C.SIDE_LEFT, C.FRONT_LEFT, C.FRONT_RIGHT, C.SIDE_RIGHT,
               C.BACK_RIGHT],
    AmbiScaling.N3D,
    np.array([1.41421356, 1.22474487, 7.07106781e-1], f32),
    np.array([
        [1.66666667e-1, 9.62250449e-2, -1.66666667e-1, -1.49071198e-1, 8.60662966e-2],
        [1.66666667e-1, 1.92450090e-1, 0.0, 0.0, -1.72132593e-1],
        [1.66666667e-1, 9.62250449e-2, 1.66666667e-1, 1.49071198e-1, 8.60662966e-2],
        [1.66666667e-1, -9.62250449e-2, 1.66666667e-1, -1.49071198e-1, 8.60662966e-2],
        [1.66666667e-1, -1.92450090e-1, 0.0, 0.0, -1.72132593e-1],
        [1.66666667e-1, -9.62250449e-2, -1.66666667e-1, 1.49071198e-1, 8.60662966e-2]], f32),
    np.array([1.0, 1.0, 1.0], f32),
    np.array([
        [1.66666667e-1, 9.62250449e-2, -1.66666667e-1, -1.49071198e-1, 8.60662966e-2],
        [1.66666667e-1, 1.92450090e-1, 0.0, 0.0, -1.72132593e-1],
        [1.66666667e-1, 9.62250449e-2, 1.66666667e-1, 1.49071198e-1, 8.60662966e-2],
        [1.66666667e-1, -9.62250449e-2, 1.66666667e-1, -1.49071198e-1, 8.60662966e-2],
        [1.66666667e-1, -1.92450090e-1, 0.0, 0.0, -1.72132593e-1],
        [1.66666667e-1, -9.62250449e-2, -1.66666667e-1, 1.49071198e-1, 8.60662966e-2]], f32))

X3D71_CONFIG = DecoderConfig(
    1, True, [C.AUX0, C.SIDE_LEFT, C.FRONT_LEFT, C.FRONT_RIGHT, C.SIDE_RIGHT, C.AUX1],
    AmbiScaling.N3D,
    np.array([1.73205081, 1.0], f32),
    np.array([
        [1.666666667e-01, 0.0, 2.356640879e-01, -1.667265410e-01],
        [1.666666667e-01, 2.033043281e-01, -1.175581508e-01, -1.678904388e-01],
        [1.666666667e-01, 2.033043281e-01, 1.175581508e-01, 1.678904388e-01],
        [1.666666667e-01, -2.033043281e-01, 1.175581508e-01, 1.678904388e-01],
        [1.666666667e-01, -2.033043281e-01, -1.175581508e-01, -1.678904388e-01],
        [1.666666667e-01, 0.0, -2.356640879e-01, 1.667265410e-01]], f32),
    np.array([1.0, 1.0], f32),
    np.array([
        [1.666666667e-01, 0.0, 2.356640879e-01, -1.667265410e-01],
        [1.666666667e-01, 2.033043281e-01, -1.175581508e-01, -1.678904388e-01],
        [1.666666667e-01, 2.033043281e-01, 1.175581508e-01, 1.678904388e-01],
        [1.666666667e-01, -2.033043281e-01, 1.175581508e-01, 1.678904388e-01],
        [1.666666667e-01, -2.033043281e-01, -1.175581508e-01, -1.678904388e-01],
        [1.666666667e-01, 0.0, -2.356640879e-01, 1.667265410e-01]], f32))

X714_CONFIG = DecoderConfig(
    1, True,
    [C.FRONT_LEFT, C.FRONT_RIGHT, C.SIDE_LEFT, C.SIDE_RIGHT, C.BACK_LEFT, C.BACK_RIGHT,
     C.TOP_FRONT_LEFT, C.TOP_FRONT_RIGHT, C.TOP_BACK_LEFT, C.TOP_BACK_RIGHT],
    AmbiScaling.N3D,
    np.array([1.0, 1.0, 1.0], f32),
    np.array([
        [1.27149251e-01, 7.63047539e-02, -3.64373750e-02, 1.59700680e-01],
        [1.07005418e-01, -7.67638760e-02, -4.92129762e-02, 1.29012797e-01],
        [1.26400196e-01, 1.77494694e-01, -3.71203389e-02, 0.0],
        [1.26396516e-01, -1.77488059e-01, -3.71297878e-02, 0.0],
        [1.06996956e-01, 7.67615256e-02, -4.92166307e-02, -1.29001640e-01],
        [1.27145671e-01, -7.63003471e-02, -3.64353304e-02, -1.59697510e-01],
        [8.80919747e-02, 7.48940670e-02, 9.08786244e-02, 6.22527183e-02],
        [1.57880745e-01, -7.28755272e-02, 1.82364187e-01, 8.74240284e-02],
        [1.57892225e-01, 7.28944768e-02, 1.82363474e-01, -8.74301086e-02],
        [8.80892603e-02, -7.48948724e-02, 9.08779842e-02, -6.22480443e-02]], f32))

_X7144_HF = np.array([
    [7.14285714e-02, 5.09426708e-02, 0.0, -8.82352941e-02],
    [7.14285714e-02, 1.01885342e-01, 0.0, 0.0],
    [7.14285714e-02, 5.09426708e-02, 0.0, 8.82352941e-02],
    [7.14285714e-02, -5.09426708e-02, 0.0, 8.82352941e-02],
    [7.14285714e-02, -1.01885342e-01, 0.0, 0.0],
    [7.14285714e-02, -5.09426708e-02, 0.0, -8.82352941e-02],
    [7.14285714e-02, 5.88235294e-02, 1.25e-01, -5.88235294e-02],
    [7.14285714e-02, 5.88235294e-02, 1.25e-01, 5.88235294e-02],
    [7.14285714e-02, -5.88235294e-02, 1.25e-01, 5.88235294e-02],
    [7.14285714e-02, -5.88235294e-02, 1.25e-01, -5.88235294e-02],
    [7.14285714e-02, 5.88235294e-02, -1.25e-01, -5.88235294e-02],
    [7.14285714e-02, 5.88235294e-02, -1.25e-01, 5.88235294e-02],
    [7.14285714e-02, -5.88235294e-02, -1.25e-01, 5.88235294e-02],
    [7.14285714e-02, -5.88235294e-02, -1.25e-01, -5.88235294e-02]], f32)

X7144_CONFIG = DecoderConfig(
    1, True,
    [C.BACK_LEFT, C.SIDE_LEFT, C.FRONT_LEFT, C.FRONT_RIGHT, C.SIDE_RIGHT, C.BACK_RIGHT,
     C.TOP_BACK_LEFT, C.TOP_FRONT_LEFT, C.TOP_FRONT_RIGHT, C.TOP_BACK_RIGHT,
     C.BOTTOM_BACK_LEFT, C.BOTTOM_FRONT_LEFT, C.BOTTOM_FRONT_RIGHT, C.BOTTOM_BACK_RIGHT],
    AmbiScaling.N3D,
    np.array([2.64575131, 1.52752523], f32), _X7144_HF,
    np.array([1.0, 1.0], f32), _X7144_HF.copy())

BUILTIN_DECODERS: dict[DevFmtChannels, DecoderConfig] = {
    DevFmtChannels.MONO: MONO_CONFIG,
    DevFmtChannels.STEREO: STEREO_CONFIG,
    DevFmtChannels.QUAD: QUAD_CONFIG,
    DevFmtChannels.X51: X51_CONFIG,
    DevFmtChannels.X61: X61_CONFIG,
    DevFmtChannels.X71: X71_CONFIG,
    DevFmtChannels.X714: X714_CONFIG,
    DevFmtChannels.X7144: X7144_CONFIG,
    DevFmtChannels.X3D71: X3D71_CONFIG,
}


def ambi_scales(scaling: AmbiScaling) -> np.ndarray:
    if scaling == AmbiScaling.N3D:
        return ambidefs.FROM_N3D
    if scaling == AmbiScaling.SN3D:
        return ambidefs.FROM_SN3D
    return ambidefs.FROM_FUMA


def ambi_layout_map(layout: AmbiLayout) -> np.ndarray:
    return ambidefs.INDEX_FROM_ACN if layout == AmbiLayout.ACN else ambidefs.INDEX_FROM_FUMA


@dataclasses.dataclass
class RendererLayout:
    """The resolved output rendering configuration for a device."""
    mode: RenderMode
    ambi_order: int
    m2d_mixing: bool
    # Dry ambisonic bus: per dry channel, the ACN index and content scale.
    dry_acn: np.ndarray             # [n_dry] int32
    dry_scale: np.ndarray           # [n_dry] f32 (1/content-scale)
    n_dry: int
    # Real output channels.
    real_channels: list[Channel]
    channel_index: dict[Channel, int]
    # Single/dual-band decode matrices [n_real, n_dry] (None for Ambi3D out).
    dec_hf: np.ndarray | None = None
    dec_lf: np.ndarray | None = None   # set iff dual-band
    xover_f0norm: float = 0.0
    avg_speaker_dist: float = 0.0
    nfc_enabled: bool = False
    # HRTF mode only: True = per-voice HRIR rendering ("full" hrtf-mode);
    # False = voices pan normally onto the ambi bus, only the baked decode
    # is binaural ("ambi1".."ambi4", panning.cpp:1062-1094).
    hrtf_full: bool = True
    # Stereo UHJ output: the FOA dry bus (FuMa2D order) encodes to L/R
    # through the UHJ encoder instead of a decode matrix.
    uhj_output: bool = False
    # Stereo TSME output: full-3D FOA ACN bus through the TSME encoder.
    tsme_output: bool = False


def init_panning(fmt: DevFmtChannels, sample_rate: int, *,
                 hq_decode: bool = True,
                 render_mode: RenderMode = RenderMode.NORMAL,
                 ambi_order: int = 1,
                 ambi_layout: AmbiLayout = AmbiLayout.ACN,
                 ambi_scaling: AmbiScaling = AmbiScaling.N3D,
                 xover_freq: float = 400.0,
                 hrtf_full: bool = True,
                 decoder=None,
                 stereo_encoding: str | None = None) -> RendererLayout:
    """Build the speaker/ambisonic rendering layout (panning.cpp InitPanning).

    For Ambi3D output the dry bus is the output itself; for speaker formats a
    2D/3D dry bus of the decoder's order feeds a (single or dual band)
    B-Format decode matrix indexed by real output channel.
    """
    if render_mode == RenderMode.HRTF:
        # InitHrtfPanning (panning.cpp:846-1138): a full-3D ambi dry bus of
        # the HRTF ambi order (1 by default) decodes through baked HRIRs; no
        # speaker decode matrices.
        count = ambidefs.channels_from_order(ambi_order)
        real_channels = DEVICE_CHANNEL_ORDER[DevFmtChannels.STEREO]
        return RendererLayout(
            mode=render_mode, ambi_order=ambi_order, m2d_mixing=False,
            dry_acn=ambidefs.INDEX_FROM_ACN[:count].astype(np.int32),
            dry_scale=np.ones(count, f32), n_dry=count,
            real_channels=real_channels,
            channel_index={ch: i for i, ch in enumerate(real_channels)},
            xover_f0norm=float(xover_freq) / float(sample_rate),
            hrtf_full=hrtf_full,
        )

    if fmt == DevFmtChannels.STEREO and stereo_encoding == "uhj":
        # InitUhjPanning (panning.cpp:1140-1162): always 2D first-order,
        # FuMa channel order (W, X, Y), N3D content scale.
        acnmap = ambidefs.INDEX_FROM_FUMA_2D[:3]
        scales = ambi_scales(AmbiScaling.N3D)
        real_channels = DEVICE_CHANNEL_ORDER[DevFmtChannels.STEREO]
        return RendererLayout(
            mode=RenderMode.NORMAL, ambi_order=1, m2d_mixing=True,
            dry_acn=acnmap.astype(np.int32),
            dry_scale=(1.0 / scales[acnmap]).astype(f32), n_dry=3,
            real_channels=real_channels,
            channel_index={ch: i for i, ch in enumerate(real_channels)},
            uhj_output=True,
        )

    if fmt == DevFmtChannels.STEREO and stereo_encoding == "tsme":
        # InitTsmePanning (panning.cpp:1164-1177): always 3D first-order,
        # ACN channel order, N3D content scale.
        acnmap = ambidefs.INDEX_FROM_ACN[:4]
        scales = ambi_scales(AmbiScaling.N3D)
        real_channels = DEVICE_CHANNEL_ORDER[DevFmtChannels.STEREO]
        return RendererLayout(
            mode=RenderMode.NORMAL, ambi_order=1, m2d_mixing=False,
            dry_acn=acnmap.astype(np.int32),
            dry_scale=(1.0 / scales[acnmap]).astype(f32), n_dry=4,
            real_channels=real_channels,
            channel_index={ch: i for i, ch in enumerate(real_channels)},
            tsme_output=True,
        )

    if fmt == DevFmtChannels.AMBI3D:
        count = ambidefs.channels_from_order(ambi_order)
        acnmap = ambi_layout_map(ambi_layout)[:count]
        scales = ambi_scales(ambi_scaling)
        dry_scale = (1.0 / scales[acnmap]).astype(f32)
        return RendererLayout(
            mode=render_mode, ambi_order=ambi_order, m2d_mixing=False,
            dry_acn=acnmap.astype(np.int32), dry_scale=dry_scale, n_dry=count,
            real_channels=[], channel_index={},
        )

    # Custom ambdec decoder replaces the built-in layout (panning.cpp:763)
    cfg = decoder if decoder is not None else BUILTIN_DECODERS[fmt]
    if decoder is not None:
        xover_freq = decoder.xover_freq
    periphonic = cfg.periphonic
    ambicount = (ambidefs.channels_from_order(cfg.order) if periphonic
                 else ambidefs.channels_from_order_2d(cfg.order))
    real_channels = DEVICE_CHANNEL_ORDER[fmt]
    channel_index = {ch: i for i, ch in enumerate(real_channels)}

    dual_band = hq_decode and cfg.coeffs_lf is not None
    ordermap = (ambidefs.ORDER_FROM_CHANNEL if periphonic
                else ambidefs.ORDER_FROM_2D_CHANNEL)

    dec_hf = np.zeros((len(real_channels), ambicount), f32)
    dec_lf = np.zeros_like(dec_hf) if dual_band else None
    for i, ch in enumerate(cfg.channels):
        idx = channel_index.get(ch)
        if idx is None:   # decoder names a channel the device lacks
            continue      # (panning.cpp:771 "Failed to find channel")
        gains = cfg.order_gain[ordermap[:ambicount]]
        dec_hf[idx] = (cfg.coeffs[i, :ambicount] * gains).astype(f32)
        if dual_band:
            gains_lf = cfg.order_gain_lf[ordermap[:ambicount]]
            dec_lf[idx] = (cfg.coeffs_lf[i, :ambicount] * gains_lf).astype(f32)

    acnmap = (ambidefs.INDEX_FROM_ACN[:ambicount] if periphonic
              else ambidefs.INDEX_FROM_ACN_2D[:ambicount])
    scales = ambi_scales(cfg.scaling)
    dry_scale = (1.0 / scales[acnmap]).astype(f32)

    return RendererLayout(
        mode=render_mode, ambi_order=cfg.order, m2d_mixing=not periphonic,
        dry_acn=acnmap.astype(np.int32), dry_scale=dry_scale, n_dry=ambicount,
        real_channels=real_channels, channel_index=channel_index,
        dec_hf=dec_hf, dec_lf=dec_lf,
        xover_f0norm=float(xover_freq) / float(sample_rate),
    )


# --- Direction warping (alu.cpp:639-707) -------------------------------------


def scale_azimuth_front3(pos: np.ndarray) -> np.ndarray:
    """Triple frontal azimuth: ±30° → ±90° (pairwise stereo panning)."""
    pos = np.array(pos, dtype=f32)
    if pos[2] < 0.0:
        len2d = f32(np.sqrt(f32(pos[0] * pos[0] + pos[2] * pos[2])))
        z = f32(-pos[2] / len2d)
        if z > f32(0.866025403785):
            x = f32(pos[0] / len2d)
            x = f32(x * 3.0 - x * x * x * 4.0)
            z = f32(z * z * z * 4.0 - z * 3.0)
            pos[0] = f32(x * len2d)
            pos[2] = f32(-z * len2d)
        else:
            pos[0] = f32(np.copysign(len2d, pos[0]))
            pos[2] = f32(0.0)
    return pos


def scale_azimuth_front3_2(pos: np.ndarray) -> np.ndarray:
    """Scale frontal azimuth by 1.5 (mono sources in pairwise mode)."""
    pos = np.array(pos, dtype=f32)
    if pos[2] < 0.0:
        len2d = f32(np.sqrt(f32(pos[0] * pos[0] + pos[2] * pos[2])))
        z = f32(-pos[2] / len2d)
        if z > f32(0.5):
            x = f32(pos[0] / len2d)
            x = f32(np.copysign(np.sqrt(f32((1.0 - z) * 0.5)), x))
            z = f32(np.sqrt(f32((1.0 + z) * 0.5)))
            x = f32(x * 3.0 - x * x * x * 4.0)
            z = f32(z * z * z * 4.0 - z * 3.0)
            pos[0] = f32(x * len2d)
            pos[2] = f32(-z * len2d)
        else:
            pos[0] = f32(np.copysign(len2d, pos[0]))
            pos[2] = f32(0.0)
    return pos


_LEFT_CHANNELS = {C.FRONT_LEFT, C.BACK_LEFT, C.SIDE_LEFT, C.TOP_FRONT_LEFT,
                  C.TOP_BACK_LEFT, C.BOTTOM_FRONT_LEFT, C.BOTTOM_BACK_LEFT}
_RIGHT_CHANNELS = {C.FRONT_RIGHT, C.BACK_RIGHT, C.SIDE_RIGHT, C.TOP_FRONT_RIGHT,
                   C.TOP_BACK_RIGHT, C.BOTTOM_FRONT_RIGHT, C.BOTTOM_BACK_RIGHT}


def pan_gain(channel: Channel, panning: float) -> f32:
    """Left/right balance gain per channel (alu.cpp GetPanGainSelector)."""
    lgain = f32(min(1.0 - panning, 1.0))
    rgain = f32(min(1.0 + panning, 1.0))
    if channel in _LEFT_CHANNELS:
        return lgain
    if channel in _RIGHT_CHANNELS:
        return rgain
    return f32(min(lgain, rgain))


def compute_pan_gains(layout_acn: np.ndarray, layout_scale: np.ndarray,
                      coeffs: np.ndarray, ingain: float) -> np.ndarray:
    """ComputePanGains (core/mixer.cpp:93-102): per-bus-channel gains."""
    return (layout_scale * coeffs[layout_acn] * f32(ingain)).astype(f32)
