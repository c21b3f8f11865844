"""The render device on torch tensors (port of core/device.py).

The whole voice population lives in one structure-of-arrays param table
(host numpy), and each dispatch renders ``n_blocks`` blocks for every voice
at once on the chosen torch device:

    resample (unit, general or span kernel) [-> UHJ/Super Stereo decode]
    -> [direct and send filters (one biquad kernel launch for all paths)]
    -> dry ambisonic bus [through the NFC filters]
    [-> wet-send mixes -> effect slots]
    -> HRTF: HRIR contraction (matmul) [+ HF scale -> baked binaural
       decode] -> skew-sum -> accumulator fold
    -> speakers: [band split] -> decode matrices [-> front stabilizer]
       or the UHJ/TSME stereo encode
    -> [n_blocks, n_real, T] output

The ported path is binaural HRTF output (per-voice HRIRs, "full" mode, or
the ``ambiN`` modes), speaker output (pairwise stereo, the built-in and
custom ambdec decoders, single- or dual-band), UHJ and TSME stereo output
and Ambi3D output; native-rate or pitched voices, B-Format voices on the
dry bus, UHJ2/3/4 and Super Stereo voices (decoded at every quality tier,
their all-passes through the biquad kernel), direct and send filters,
near-field compensation, and effect slots (every EFX engine; the
dedicated dialog and LFE engines also write the real output).
The resampler follows the pool: the general kernel reads taps straight
from a pool that fits L2, the span kernel stages each tile's window from
one that does not (``_rs_plan``).  Multi-block dispatches of unfiltered
HRTF scenes without UHJ voices take the fused super-block branch (one
resample + one contraction per 2..16 blocks, the effects at the whole
window where their rings allow); other multi-block dispatches resample
once per super-block and render each block on its slice (with the UHJ
decoders' look-ahead); single blocks take the per-block branch.  On the
card nothing falls back to the CPU.

Idiom: ``lax.scan`` with donated state becomes a Python loop that updates
the carried state (``_state``) and the evolving fields (``ev``) in place and
writes each block into a preallocated output, copied to the host once per
dispatch.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..constants import (
    BUFFER_LINE_SIZE,
    GAIN_FADE_SAMPLES,
    MAX_AMBI_CHANNELS,
    MIXER_FRAC_BITS,
)
from ..core import context as cparams
from ..core import hrtf as hrtf_mod
from ..core import logging as log
from ..core import mastering, panning
from ..core.devformat import Channel, DevFmtChannels, DevFmtType, FmtChannels
from ..core.voice import PlayState
from ..ops import tables

from .._device import resolve_device
from ..ops import filters as f_ops
from ..ops import hrtf_mix
from ..ops import mix as mix_ops
from ..ops import nfc as nfc_ops
from ..ops import resample as rs_ops
from ..ops import uhj as uhj_ops
from ..ops.kernels import biquad as biq
from ..ops.kernels import resample_gen as rs_gen
from ..ops.kernels import resample_span as rs_span
from ..ops.kernels import resample_unit as rs_unit

f32 = np.float32
# UHJ voice kinds: (state key, decoded channels, buffer channels).
_UHJ_KINDS = {FmtChannels.UHJ2: ("u2", 3, 2), FmtChannels.UHJ3: ("u3", 3, 3),
              FmtChannels.UHJ4: ("u4", 4, 4),
              FmtChannels.SUPER_STEREO: ("ss", 3, 2)}
# The UHJ2 quad decode's LF shelving (sWLFScale, sXYLFScale).
_UHJ2_LF = (0.661, 1.293, 1.293)
L2_BYTES_CPU = 50 << 20   # the span plan's threshold on the CPU (an H100's L2)


def _to_dev(a, device: torch.device) -> torch.Tensor:
    """A device copy of a host array (never a view: state updates in place)."""
    return torch.tensor(np.asarray(a), device=device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# Integer scalars of the effect state keep the JAX package's dtypes in a
# snapshot; on the device they are int64.
_SNAP_INT_DTYPES = {"mod_index": np.uint32, "offset": np.int32,
                    "serial_done": np.int32, "index": np.int32,
                    "pos": np.int32, "phase": np.int32, "lfo_ns": np.int32}


def _state_to_host(state: dict) -> dict:
    """The carried state (nested for effect slots) as numpy arrays."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = _state_to_host(v)
        elif k in _SNAP_INT_DTYPES and not v.dtype.is_floating_point:
            out[k] = _to_host(v).astype(_SNAP_INT_DTYPES[k])
        else:
            out[k] = _to_host(v)
    return out


def _state_to_dev(state: dict, device: torch.device) -> dict:
    """Inverse of _state_to_host; integer leaves become int64."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = _state_to_dev(v, device)
        else:
            a = np.asarray(v)
            out[k] = _to_dev(a.astype(np.int64) if a.dtype.kind in "iu"
                             else a, device)
    return out


class BufferPool:
    """Device-resident sample pool with a host-side bump/free allocator.

    Decoded float32 planar buffer data is uploaded once; voices read it with
    affine index math (replacing the reference's per-block staging copies
    in Voice::mix, core/voice.cpp:867-931).
    """

    def __init__(self, initial_capacity: int = 1 << 20) -> None:
        self._host = np.zeros(initial_capacity, f32)
        self._top = 8  # offset 0 reserved: silence guard
        self._free: list[tuple[int, int]] = []
        self._device: torch.Tensor | None = None
        self._dirty = True

    def alloc(self, data: np.ndarray) -> int:
        n = data.size
        for i, (off, sz) in enumerate(self._free):
            if sz >= n:
                self._free.pop(i)
                if sz > n:
                    self._free.append((off + n, sz - n))
                self._host[off:off + n] = data.ravel()
                self._dirty = True
                return off
        while self._top + n + 4096 > self._host.size:
            self._host = np.concatenate([self._host,
                                         np.zeros(self._host.size, f32)])
        off = self._top
        self._top += n
        self._host[off:off + n] = data.ravel()
        self._dirty = True
        return off

    def free(self, offset: int, size: int) -> None:
        # Coalesce with adjacent free spans so buffer churn doesn't fragment
        # the pool.
        self._free.append((offset, size))
        self._free.sort()
        merged: list[tuple[int, int]] = []
        for off, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        # A top-adjacent free span returns to the bump allocator.
        if merged and merged[-1][0] + merged[-1][1] == self._top:
            self._top = merged.pop()[0]
        self._free = merged

    def device_array(self, device: torch.device) -> torch.Tensor:
        if self._dirty or self._device is None:
            self._device = _to_dev(self._host, device)
            self._dirty = False
        return self._device


@dataclasses.dataclass
class ParamTable:
    """SoA per-line mixing parameters (the atomically-swapped props of the
    reference, batched).  One row = one voice mixing channel."""
    capacity: int
    n_dry: int
    n_sends: int
    n_wet: int

    def __post_init__(self) -> None:
        L = self.capacity
        S = max(self.n_sends, 1)
        self.active = np.zeros(L, bool)
        self.playing = np.zeros(L, bool)
        self.fade = np.zeros(L, np.int32)
        self.pos_int = np.zeros(L, np.int32)
        self.pos_frac = np.zeros(L, np.int32)
        self.increment = np.full(L, 1, np.int32)
        self.bank_row = np.zeros(L, np.int32)
        self.sf = np.zeros(L, f32)
        self.src_off = np.zeros(L, np.int32)
        self.src_len = np.zeros(L, np.int32)
        self.loop_start = np.zeros(L, np.int32)
        self.loop_end = np.full(L, 1, np.int32)
        self.has_loop = np.zeros(L, bool)
        self.has_wrapped = np.zeros(L, bool)
        self.dry_cur = np.zeros((L, self.n_dry), f32)
        self.dry_tgt = np.zeros((L, self.n_dry), f32)
        self.filter_active = np.zeros(L, bool)
        self.filter_coeffs = np.zeros((L, 2, 5), f32)
        self.filter_target = np.zeros((L, 2, 5), f32)
        self.filter_counter = np.zeros(L, np.int32)
        # Identity biquads by default
        self.filter_coeffs[:, :, 0] = 1.0
        self.filter_target[:, :, 0] = 1.0
        # HRTF rows: 192-tap HRIRs, each shifted by its integer delay on the
        # host, so the device needs no per-bin phase factors.
        self.hrtf_gain = np.zeros(L, f32)
        self.hrtf_old_gain = np.zeros(L, f32)
        self.hrtf_coeffs = np.zeros((L, 192, 2), f32)
        self.hrtf_old_coeffs = np.zeros((L, 192, 2), f32)
        self.hrtf_delay = np.zeros((L, 2), np.int32)
        self.hrtf_old_delay = np.zeros((L, 2), np.int32)
        # Wet sends: routing + gains
        self.wet_slot = np.zeros((L, S), np.int32)
        self.wet_active = np.zeros((L, S), bool)
        self.wet_cur = np.zeros((L, S, self.n_wet), f32)
        self.wet_tgt = np.zeros((L, S, self.n_wet), f32)
        self.send_filter_active = np.zeros((L, S), bool)
        self.send_filter_coeffs = np.zeros((L, S, 2, 5), f32)
        self.send_filter_target = np.zeros((L, S, 2, 5), f32)
        self.send_filter_counter = np.zeros((L, S), np.int32)
        self.send_filter_coeffs[:, :, :, 0] = 1.0
        self.send_filter_target[:, :, :, 0] = 1.0
        # NFC: w0 per row, -1.0 = create-state identity filter.
        self.nfc_w0 = np.full(L, -1.0, f32)
        self.nfc_active = np.zeros(L, bool)

    # Fields that evolve deterministically on the device within a dispatch;
    # the host mirrors their end state with identical integer/f32 math, so
    # they upload once per dispatch — not per block.
    _EVOLVING = ("pos_int", "pos_frac", "fade", "has_wrapped", "dry_cur",
                 "filter_coeffs", "filter_counter", "wet_cur",
                 "send_filter_coeffs", "send_filter_counter")
    # Configuration fields: change only on voice/param events.
    _CONFIG = ("active", "playing", "increment", "bank_row", "sf", "src_off",
               "src_len", "loop_start", "loop_end", "has_loop",
               "dry_tgt", "filter_active", "filter_target", "hrtf_gain",
               "hrtf_old_gain", "hrtf_coeffs", "hrtf_old_coeffs", "hrtf_delay",
               "hrtf_old_delay", "wet_slot", "wet_active", "wet_tgt",
               "send_filter_active", "send_filter_target",
               "nfc_w0", "nfc_active")
    _FIELDS = _EVOLVING + _CONFIG

    def evolving_dict(self, device: torch.device) -> dict:
        out = {k: _to_dev(getattr(self, k), device) for k in self._EVOLVING}
        # -1 marks never-initialized interp filters host-side; device sees 0.
        out["filter_counter"].clamp_(min=0)
        return out

    def clear_row(self, r: int) -> None:
        self.active[r] = False
        self.playing[r] = False
        self.fade[r] = 0
        self.dry_cur[r] = 0.0
        self.dry_tgt[r] = 0.0
        self.wet_cur[r] = 0.0
        self.wet_tgt[r] = 0.0
        self.filter_active[r] = False
        self.filter_coeffs[r] = 0.0
        self.filter_coeffs[r, :, 0] = 1.0
        self.filter_target[r] = self.filter_coeffs[r]
        self.filter_counter[r] = -1  # fresh filter: first update snaps
        self.send_filter_counter[r] = 0
        self.hrtf_gain[r] = 0.0
        self.hrtf_old_gain[r] = 0.0
        self.hrtf_coeffs[r] = 0.0
        self.hrtf_old_coeffs[r] = 0.0
        self.hrtf_delay[r] = 0
        self.hrtf_old_delay[r] = 0
        self.nfc_w0[r] = -1.0
        self.nfc_active[r] = False


class RenderDevice:
    """A playback device rendering on one torch device: ``"cuda"`` by
    default (raises without a card), or ``"cpu"`` when asked for."""

    def __init__(self, sample_rate: int = 48000,
                 fmt_channels: DevFmtChannels = DevFmtChannels.STEREO,
                 fmt_type: DevFmtType = DevFmtType.FLOAT,
                 *, capacity: int = 256, num_aux_sends: int = 2,
                 render_mode: panning.RenderMode | None = None,
                 hq_decode: bool = True,
                 ambi_order: int = 1,
                 hrtf_path: str | None = None,
                 loopback: bool = True,
                 device: str | torch.device = "cuda") -> None:
        from ..alc import config as alconf

        self.torch_device = resolve_device(device)
        self.sample_rate = int(sample_rate)
        self.fmt_channels = fmt_channels
        self.fmt_type = fmt_type
        self.capacity = capacity
        self.num_aux_sends = num_aux_sends
        self.hrtf_store = None

        stereo_encoding = None
        if render_mode is None:
            # Default stereo output pans pairwise (panning.cpp:1420); the
            # stereo-encoding key selects UHJ, TSME or HRTF instead.
            render_mode = (panning.RenderMode.PAIRWISE
                           if fmt_channels == DevFmtChannels.STEREO
                           else panning.RenderMode.NORMAL)
            if fmt_channels == DevFmtChannels.STEREO:
                enc = (alconf.config_value_str("", "stereo-encoding")
                       or "").lower()
                if enc in ("uhj", "tsme"):
                    stereo_encoding = enc
                    render_mode = panning.RenderMode.NORMAL
                elif enc == "hrtf":
                    render_mode = panning.RenderMode.HRTF
        hrtf_full = True
        if render_mode == panning.RenderMode.HRTF:
            # InitHrtfPanning (panning.cpp:846-1138): "full" renders each
            # voice through its own HRIRs; "ambi1".."ambi4" pan onto an
            # ambisonic bus with a baked binaural decode.
            mode_str = (alconf.config_value_str("", "hrtf-mode")
                        or "full").lower()
            if mode_str == "basic":   # deprecated alias (panning.cpp:1078)
                mode_str = "ambi2"
            if mode_str in ("ambi1", "ambi2", "ambi3", "ambi4"):
                hrtf_full = False
                ambi_order = int(mode_str[-1])
            else:
                ambi_order = 1
        custom_decoder = self._custom_decoder(render_mode, fmt_channels,
                                              alconf)
        self.layout = panning.init_panning(
            fmt_channels, self.sample_rate, hq_decode=hq_decode,
            render_mode=render_mode, ambi_order=ambi_order,
            xover_freq=700.0 if render_mode == panning.RenderMode.HRTF
            else 400.0,
            hrtf_full=hrtf_full, decoder=custom_decoder,
            stereo_encoding=stereo_encoding)
        self.n_dry = self.layout.n_dry
        self.n_real = len(self.layout.real_channels) or self.n_dry

        if render_mode == panning.RenderMode.HRTF:
            # Enumerated + rate-resampled load (GetLoadedHrtf,
            # core/hrtf.cpp:466-608); synthetic set when none is found.
            store = hrtf_mod.load_hrtf(self.sample_rate, path=hrtf_path)
            self.hrtf_store = (store if store is not None
                               else hrtf_mod.make_synthetic_hrtf(
                                   self.sample_rate))
            log.trace("HRTF enabled: %s order, rate %d, ir %d", ambi_order,
                      self.hrtf_store.sample_rate, self.hrtf_store.ir_size)
            # The dry ambisonic bus decodes to binaural through baked HRIRs,
            # zero-extended to the voices' 192-tap frame so both accumulate
            # through one skew-sum; its high band is scaled per channel.
            direct = hrtf_mod.build_direct_hrtf(
                self.hrtf_store, self.hrtf_store.ir_size, ambi_order)
            dc = np.asarray(direct.coeffs, f32)
            self._direct_coeffs = _to_dev(np.concatenate(
                [dc, np.zeros((dc.shape[0], hrtf_mix.HRIR_EXT - dc.shape[1],
                               2), f32)], axis=1), self.torch_device)
            self._direct_hf_scales = _to_dev(
                np.asarray(direct.hf_scales, f32), self.torch_device)
            self._hrtf_splitter = f_ops.BandSplitterKernels(
                float(f_ops.band_splitter_coeff(700.0 / self.sample_rate)),
                variant_3arg=True)

        # Near-field compensation (InitNearFieldCtrl, panning.cpp:276-300):
        # the control distance sets the per-device NFC constants; the voice
        # params read avg_speaker_dist for their per-voice w0.
        self.nfc = None
        self.avg_speaker_dist = 0.0
        self.nfc_scale = float(np.clip(alconf.config_value_float(
            "game_compat", "nfc-scale", 1.0), 0.0001, 10000.0))
        if alconf.config_value_bool("decoder", "nfc", False):
            ctrl = 0.0
            if self.layout.mode == panning.RenderMode.HRTF:
                ctrl = float(self.hrtf_store.field_distances[0])
            elif custom_decoder is not None:
                dists = custom_decoder.speaker_dists
                pos = dists[dists > 0.0]
                ctrl = (float(pos.mean()) if pos.size
                        else alconf.config_value_float(
                            "decoder", "speaker-dist", 1.0))
            elif self.layout.uhj_output:
                ctrl = alconf.config_value_float("uhj", "distance-ref", 2.0)
            elif (self.layout.dec_hf is None
                  and fmt_channels == DevFmtChannels.AMBI3D):
                ctrl = alconf.config_value_float("decoder", "speaker-dist",
                                                 0.0) or 0.0
            if ctrl > 0.0:
                self.avg_speaker_dist = float(np.clip(ctrl, 0.1, 10.0))
                w1 = float(nfc_ops.SPEED_OF_SOUND
                           / (f32(self.avg_speaker_dist)
                              * f32(self.sample_rate)))
                self.nfc = nfc_ops.NfcDeviceConsts(w1)
                log.trace("Using near-field reference distance: %.2f meters",
                          self.avg_speaker_dist)
        if self.nfc is not None:
            # Dry-channel spans per ambisonic order (contiguous in ACN
            # order; dry_acn holds true ACN indices for 2D and 3D buses).
            order_of = np.floor(np.sqrt(self.layout.dry_acn)).astype(int)
            self._nfc_groups = []
            for o in range(int(order_of.max()) + 1):
                idx = np.nonzero(order_of == o)[0]
                assert (np.diff(idx) == 1).all(), "non-contiguous order group"
                self._nfc_groups.append((int(idx[0]), int(idx[-1]) + 1))

        # Distance compensation (InitDistanceComp, panning.cpp:301-360):
        # per-speaker whole-sample delay + level scale on the real outputs.
        self._dist_comp = None
        if (custom_decoder is not None
                and custom_decoder.speaker_dists is not None
                and alconf.config_value_bool("decoder", "distance-comp",
                                             True)):
            self._dist_comp = self._distance_comp_params(custom_decoder)

        # The speaker decode: matrices [n_real, n_dry] with -100 dB entries
        # zeroed (MixSamples silence-skip, mixer_c.cpp:180-181), a band
        # splitter for the dual-band decode; None for Ambi3D output, where
        # the dry bus is the output.
        def _thresh(m):
            if m is None:
                return None
            out = np.array(m, f32)
            out[np.abs(out) <= 1.0e-5] = 0.0
            return _to_dev(out, self.torch_device)

        self._dec_hf = _thresh(self.layout.dec_hf)
        self._dec_lf = _thresh(self.layout.dec_lf)
        self._splitter = (f_ops.BandSplitterKernels(
            float(f_ops.band_splitter_coeff(self.layout.xover_f0norm)))
            if self._dec_lf is not None else None)
        # Front stabilizer (alu.cpp:329-405): speaker decodes with FL/FR/FC
        # outputs where the decoder leaves FC silent; config-gated.  Splits
        # the decoded front mid at 5 kHz and re-pans LF 1/3 and HF 1/4
        # toward center, all-passing every other channel into phase.
        self._stab = None
        if (self.layout.dec_hf is not None
                and alconf.config_value_bool("", "front-stablizer", False)):
            ci = self.layout.channel_index
            need = (Channel.FRONT_LEFT, Channel.FRONT_RIGHT,
                    Channel.FRONT_CENTER)
            if all(ch in ci for ch in need):
                cidx = ci[Channel.FRONT_CENTER]
                hasfc = bool(np.any(self.layout.dec_hf[cidx]))
                if self.layout.dec_lf is not None:
                    hasfc |= bool(np.any(self.layout.dec_lf[cidx]))
                if not hasfc:
                    self._stab = {
                        "idx": (ci[Channel.FRONT_LEFT],
                                ci[Channel.FRONT_RIGHT], cidx),
                        "coeff": float(f_ops.band_splitter_coeff(
                            5000.0 / self.sample_rate)),
                    }

        self.pool = BufferPool()
        self.table = ParamTable(capacity, self.n_dry, num_aux_sends,
                                MAX_AMBI_CHANNELS)
        # UHJ/TSME codec quality tiers (uhj/decode-filter etc.,
        # alc/alc.cpp:548-585): iir (default), fir256 or fir512.
        def _quality(block: str, key: str) -> str:
            v = (alconf.config_value_str(block, key) or "iir").lower()
            return v if v in ("iir", "fir256", "fir512") else "iir"
        self._uhj_dec_q = _quality("uhj", "decode-filter")
        self._tsme_dec_q = _quality("tsme", "decode-filter")
        self._uhj_enc_q = _quality("uhj", "encode-filter")
        self._tsme_enc_q = _quality("tsme", "encode-filter")
        self._uhj_enc = None
        self._tsme_enc = None
        # UHJ voices by kind; their decode state lives in _state.
        self._uhj_groups: dict = {"u2": [], "u3": [], "u4": [], "ss": []}
        self._uhj_adopt = False   # a restored snapshot's decode state
        self._uhj_splitter = f_ops.BandSplitterKernels(
            float(f_ops.band_splitter_coeff(self.layout.xover_f0norm)))
        # The span plan's threshold: the card's L2 (a fixed 50 MiB on the
        # CPU; tests may lower it), against the union of the active voices'
        # buffer extents, measured at each config upload.
        self.l2_bytes = (
            torch.cuda.get_device_properties(self.torch_device).L2_cache_size
            if self.torch_device.type == "cuda" else L2_BYTES_CPU)
        self._pool_extent_bytes = 0
        self._max_inc = 1 << MIXER_FRAC_BITS
        # Cross-thread protocol: the render thread and app threads
        # serialize on this lock (the mutex analog of the reference's
        # wait-free prop-swap discipline, alu.cpp:2009-2013).
        self.lock = threading.RLock()
        # ALC_CONNECTED: cleared once by handle_disconnect when the backend
        # loses its output.
        self.connected = True
        self._free_rows = list(range(capacity - 1, -1, -1))
        self._bank = tables.weight_bank()          # host numpy
        self._bank_dev = None                      # torch copy, on first use
        self._taps = 4  # raised when voices use bsinc resamplers
        self._cfg_dev = None
        self._ev_dev = None   # device-evolved copy of the _EVOLVING fields
        self._ev_fade = False  # host mirror of bool(_ev_dev["fade"].any())
        self._cfg_has_resets = False
        self._pending_resets: set[int] = set()
        self.contexts: list = []
        # Effect slots: aluInitEffectPanning gives each slot a full-order
        # ambisonic wet bus (ACN, unit scale).
        self.wet_channels = (self.layout.ambi_order + 1) ** 2
        self.slots: list = []
        self._bank_sl = None   # (taps, bank sliced for the general kernel)
        self._state = self._init_state()
        self._clock_samples = 0
        self._carry: np.ndarray | None = None  # rendered-ahead frames (f32)

        # BS2B crossfeed (panning.cpp:1421-1431): basic stereo, never on
        # loopback devices.
        self._bs2b = None
        if (fmt_channels == DevFmtChannels.STEREO
                and not loopback
                and render_mode != panning.RenderMode.HRTF
                and not self.layout.uhj_output):
            cf = alconf.config_value_int("", "cf_level", 0) or 0
            if 1 <= cf <= 6:
                from ..core import bs2b as bs2b_mod
                self._bs2b = bs2b_mod.Bs2bProcessor(cf, self.sample_rate)

        # Output stage (alc/alc.cpp:1677-1763): dither for 8/16-bit output,
        # limiter for integer formats, volume-adjust in dB.
        depth = mastering.default_dither_depth(fmt_type.name)
        if not alconf.config_value_bool("", "dither", True):
            depth = 0
        elif (dd := alconf.config_value_int("", "dither-depth", 0) or 0) > 0:
            depth = int(np.clip(dd, 2, 24))
        self.dither = (mastering.DitherState(depth) if depth > 0 else None)
        self.limiter = None
        lim_opt = alconf.config_value_str("", "output-limiter")
        want_limiter = (fmt_type != DevFmtType.FLOAT
                        if lim_opt is None
                        else lim_opt.lower() in ("true", "yes", "on", "1"))
        if want_limiter:
            thr_db = mastering.limiter_threshold_db(fmt_type.name, depth)
            self.limiter = mastering.Limiter(self.n_real,
                                             float(self.sample_rate), thr_db)
        vol_db = alconf.config_value_float("", "volume-adjust", 0.0) or 0.0
        self._volume_scale = (float(10.0 ** (vol_db / 20.0))
                              if vol_db else None)

    @staticmethod
    def _custom_decoder(render_mode, fmt_channels, alconf):
        """Custom ambdec decoder for speaker layouts (aluInitRenderer,
        panning.cpp:1236-1296): config key decoder/<layout> names it."""
        if render_mode == panning.RenderMode.HRTF:
            return None
        keys = {
            DevFmtChannels.QUAD: "quad", DevFmtChannels.X51: "surround51",
            DevFmtChannels.X61: "surround61",
            DevFmtChannels.X71: "surround71",
            DevFmtChannels.X714: "surround714",
            DevFmtChannels.X7144: "surround7144",
            DevFmtChannels.X3D71: "3d71",
        }
        key = keys.get(fmt_channels)
        if key is None:
            return None
        decopt = alconf.config_value_str("decoder", key)
        if decopt is None and key == "3d71":
            decopt = alconf.config_value_str("decoder", "surround3d71")
        if not decopt:
            return None
        from ..core import ambdec as ambdec_mod
        from ..core import helpers

        decopt = helpers.find_data_file(decopt, ".ambdec", "presets") or decopt
        conf = ambdec_mod.load_ambdec(decopt)
        log.trace("Using %s decoder: %s", key, conf.description)
        return ambdec_mod.make_decoder(conf, fmt_channels)

    def _distance_comp_params(self, decoder):
        dists = decoder.speaker_dists
        maxdist = float(dists.max(initial=0.0))
        if not maxdist > 0.0:
            return None
        scale = f32(self.sample_rate) / cparams.SPEED_OF_SOUND
        delays = np.zeros(self.n_real, np.int64)
        gains = np.ones(self.n_real, f32)
        for ch, dist in zip(decoder.channels, dists):
            idx = self.layout.channel_index.get(ch)
            if idx is None or not dist > 0.0:
                continue
            delays[idx] = int(np.floor(f32((maxdist - dist) * scale)
                                       + f32(0.5)))
            gains[idx] = f32(dist / maxdist)
        return delays, gains, [np.zeros(int(d), f32) for d in delays]

    # --- row allocation ---

    def alloc_rows(self, n: int) -> list[int]:
        with self.lock:
            if len(self._free_rows) < n:
                raise RuntimeError(
                    f"voice capacity exhausted: {n} rows requested, "
                    f"{len(self._free_rows)} free of {self.capacity} "
                    f"(raise the device's `capacity` or stop sources first)")
            rows = [self._free_rows.pop() for _ in range(n)]
            for r in rows:
                self.table.clear_row(r)
            self._pending_resets.update(rows)
            self._cfg_dev = None
            return rows

    def free_rows(self, rows: list[int]) -> None:
        with self.lock:
            for r in rows:
                self.table.clear_row(r)
                self._free_rows.append(r)
            self._cfg_dev = None

    def set_taps(self, taps: int) -> None:
        self._taps = max(self._taps, taps)

    # --- effect slots ---

    def register_slot(self, slot) -> int:
        self.slots.append(slot)
        idx = len(self.slots) - 1
        self._state[f"slot{idx}"] = slot.state.device_update()
        self._cfg_dev = None
        return idx

    def slot_effect_changed(self, slot, buffer=None) -> None:
        self._state[f"slot{slot.index}"] = slot.state.device_update(buffer)
        self._cfg_dev = None

    def _graph_gates(self) -> tuple:
        """Host-known scene facts that prune the block path: no direct
        filters, no send filters, nothing on the dry ambisonic bus (per-
        voice HRIRs only, no slots, no NFC)."""
        g = []
        t = self.table
        if not bool(t.filter_active[t.active].any()):
            g.append("gate:nofilt")
        if not bool(t.send_filter_active[t.active].any()):
            g.append("gate:nosendfilt")
        if (self.layout.mode == panning.RenderMode.HRTF and not self.slots
                and self.nfc is None
                and not bool(np.any(t.dry_tgt[t.active]))):
            g.append("gate:nodry")
        return tuple(g)

    # --- carried device state ---

    def _init_state(self) -> dict:
        """The carried state, under the JAX package's names and shapes so
        that snapshots cross between the two."""
        L = self.capacity
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=self.torch_device)
        state = {"filter_z": z(L, 2, 2),
                 "send_filter_z": z(L, max(self.num_aux_sends, 1), 2, 2)}
        if self.layout.dec_lf is not None:
            state["split_state"] = z(self.n_dry, 3)
        if self.nfc is not None:
            state["nfc_z"] = z(L, nfc_ops.NUM_STATES)
        dev = self.torch_device
        if self.layout.uhj_output:
            if self._uhj_enc_q == "iir":
                state.update(uhj_ops.uhj_encoder_iir_state(dev))
            else:
                self._uhj_enc = uhj_ops.UhjEncoderState(
                    512 if self._uhj_enc_q == "fir512" else 256)
                state.update({f"uhjenc_{k}": v
                              for k, v in self._uhj_enc.init(dev).items()})
        if self.layout.tsme_output:
            if self._tsme_enc_q == "iir":
                state.update(uhj_ops.tsme_encoder_iir_state(dev))
            else:
                self._tsme_enc = uhj_ops.TsmeEncoderState(
                    512 if self._tsme_enc_q == "fir512" else 256)
                state.update({f"tsmeenc_{k}": v
                              for k, v in self._tsme_enc.init(dev).items()})
        if self._stab is not None:
            state["stab_mid"] = z(1, 3)
            state["stab_ap"] = z(self.n_real)
        if self.layout.mode == panning.RenderMode.HRTF:
            state["hrtf_history"] = z(L, hrtf_mix.HIST)
            state["hrtf_tail"] = z(128, 2)
            state["direct_split"] = z(self.n_dry, 3)
        return state

    # --- the resampler plan ---

    # Largest blocks per resample call (the JAX package's super-block
    # ladder).  Positions are taken in 64 bits, so nothing else bounds it.
    _RS_SUPER_BLOCKS = (16, 8, 4, 2)

    def _pool_extent(self) -> int:
        """Bytes of the union of the active voices' buffer extents,
        merged in 128-frame rows as the JAX package's shared_layout merges
        them (each extent reaching past its loop end by the taps)."""
        t = self.table
        act = t.active
        off = t.src_off[act].astype(np.int64)
        end = (off + np.maximum(t.src_len[act], t.loop_end[act])
               + self._taps + 1)
        rows = 0
        hi_row = -1
        for lo, hi in sorted(set(zip((off >> 7).tolist(),
                                     (-(-end // 128)).tolist()))):
            if lo > hi_row:
                rows += hi - lo
                hi_row = hi
            elif hi > hi_row:
                rows += hi - hi_row
                hi_row = hi
        return rows * 128 * 4

    def _rs_plan(self, T: int, n_blocks: int) -> tuple[str, int]:
        """(kind, sb): ``"unit"`` when every active increment is exactly
        1<<16 (the unit kernel); else ``"span"`` (the span kernel) when
        the active voices' buffers outgrow L2 and every looping voice's
        loop covers a span tile's window, as the JAX package's plan takes
        its per-voice-DMA kernel when the buffers outgrow the VMEM image
        (core/device.py:1898-1941); else ``"gen"`` (the general kernel,
        exact for any loop length).  sb blocks share one resample (and,
        on the fused branch, one HRTF contraction)."""
        t = self.table
        act = t.active
        # The span and general kernels size their windows for every row.
        self._max_inc = int(t.increment.max())
        if bool(np.all(t.increment[act] == 1 << MIXER_FRAC_BITS)):
            kind = "unit"
        elif self._pool_extent_bytes > self.l2_bytes:
            loops = t.has_loop & act
            win = rs_span.window_frames(self._max_inc, self._taps)
            kind = ("span" if bool(np.all(
                t.loop_end[loops] - t.loop_start[loops] >= win)) else "gen")
        else:
            kind = "gen"
        sb = next((s for s in self._RS_SUPER_BLOCKS if n_blocks % s == 0), 1)
        return kind, sb

    # --- the block path ---

    def _resample(self, pool, cfg: dict, ev: dict, n: int, kind: str):
        if kind == "unit":
            return rs_unit.resample_unit(
                pool, cfg["src_off"], cfg["src_len"], cfg["loop_start"],
                cfg["loop_end"], cfg["has_loop"], ev["has_wrapped"],
                ev["pos_int"], cfg["rs_unit_w"], n)
        if self._bank_dev is None:
            self._bank_dev = {k: _to_dev(v, self.torch_device)
                              for k, v in self._bank.items()}
        if self._bank_sl is None or self._bank_sl[0] != self._taps:
            self._bank_sl = (self._taps,
                             rs_gen.slice_bank(self._bank_dev, self._taps))
        args = (pool, cfg["src_off"], cfg["src_len"], cfg["loop_start"],
                cfg["loop_end"], cfg["has_loop"], ev["has_wrapped"],
                ev["pos_int"], ev["pos_frac"], cfg["increment"],
                cfg["bank_row"], cfg["sf"], self._bank_dev, n, self._taps)
        fn = rs_span.resample_span if kind == "span" else rs_gen.resample_gen
        return fn(*args, bank_sl=self._bank_sl[1], max_inc=self._max_inc)

    def _filters(self, state: dict, ev: dict, cfg: dict, x,
                 gates: tuple, sends: bool):
        """The voices' filter paths over the unfiltered x: the direct path
        and, with ``sends``, every aux send, each filtering the same x (one
        ``biquad_paths`` launch for all; the plain version on the CPU).
        Each path returns its filtered lines where its active mask is set
        and x elsewhere; its memories, current coefficients and counter
        update in place, inactive lines cleared (DoFilters, voice.cpp:254)
        with their schedule on target.  Under gate:nofilt (gate:nosendfilt)
        the direct path (the sends) take x as it is, their memories stay
        cleared and their schedules converged (the all-inactive result
        without the pass).  Returns (direct [V, n], [send [V, n]])."""
        paths, names = [], []
        if "gate:nofilt" in gates:
            state["filter_z"].zero_()
            ev["filter_coeffs"].copy_(cfg["filter_target"])
            ev["filter_counter"].zero_()
        else:
            paths.append(biq.FilterPath(
                state["filter_z"], ev["filter_coeffs"], cfg["filter_target"],
                ev["filter_counter"], cfg["filter_active"]))
            names.append("direct")
        n_sends = self.num_aux_sends if sends else 0
        if n_sends and "gate:nosendfilt" in gates:
            state["send_filter_z"].zero_()
            ev["send_filter_coeffs"].copy_(cfg["send_filter_target"])
            ev["send_filter_counter"].zero_()
        elif n_sends:
            for snd in range(n_sends):
                paths.append(biq.FilterPath(
                    state["send_filter_z"][:, snd],
                    ev["send_filter_coeffs"][:, snd],
                    cfg["send_filter_target"][:, snd],
                    ev["send_filter_counter"][:, snd],
                    cfg["send_filter_active"][:, snd]))
                names.append(snd)
        ys = (dict(zip(names, biq.biquad_paths(x.contiguous(), paths)))
              if paths else {})
        return ys.get("direct", x), [ys.get(snd, x) for snd in range(n_sends)]

    def _dry_bus(self, state: dict, ev: dict, cfg: dict, x, fade_len: int,
                 no_dry: bool):
        """The dry ambisonic bus [n_dry, n], or None under gate:nodry, where
        the current dry gains land on their (zero) targets as the 64-sample
        ramp would by block end.  With NFC (DoNfcMix, voice.cpp:660-691)
        the order-0 channels mix x and each higher order mixes x through
        its NFC filter; rows without NFC bypass it."""
        dry_tgt = torch.where(cfg["playing"][:, None], cfg["dry_tgt"], 0.0)
        if no_dry:
            ev["dry_cur"].copy_(dry_tgt)
            return None
        if self.nfc is None:
            dry, cur2 = mix_ops.mix_voices(x, ev["dry_cur"], dry_tgt,
                                           ev["fade"], fade_len)
            ev["dry_cur"].copy_(cur2)
            return dry
        filt, nz2 = nfc_ops.process_orders(
            x, state["nfc_z"], cfg["nfc_coeffs"], self.nfc,
            len(self._nfc_groups) - 1)
        na = cfg["nfc_active"][:, None]
        state["nfc_z"].copy_(torch.where(na, nz2, 0.0))
        pieces = []
        for o, (lo, hi) in enumerate(self._nfc_groups):
            src = x if o == 0 else torch.where(na, filt[o - 1], x)
            piece, cur2 = mix_ops.mix_voices(src, ev["dry_cur"][:, lo:hi],
                                             dry_tgt[:, lo:hi], ev["fade"],
                                             fade_len)
            pieces.append(piece)
            ev["dry_cur"][:, lo:hi] = cur2
        return torch.cat(pieces, dim=0)

    def _wet_buses(self, ev: dict, cfg: dict, x, xs: list, fade_len: int):
        """The slots' wet buses [n_slots, B, n] of x [V, n]: each send's
        lines ``xs[snd]`` (x through that send's filters, ``_filters``) mix
        onto the bus of its slot (one grouped contraction per send)."""
        n_slots, B = len(self.slots), self.wet_channels
        wet = torch.zeros((n_slots, B, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        for snd, xsnd in enumerate(xs):
            group = torch.where(cfg["wet_active"][:, snd],
                                cfg["wet_slot"][:, snd], n_slots)
            wet_tgt = torch.where(cfg["playing"][:, None],
                                  cfg["wet_tgt"][:, snd, :B], 0.0)
            bus, cur2 = mix_ops.mix_voices_grouped(
                xsnd, ev["wet_cur"][:, snd, :B], wet_tgt, ev["fade"], group,
                n_slots + 1, fade_len)
            wet = wet + bus[:n_slots]
            ev["wet_cur"][:, snd, :B] = cur2
        return wet

    def _run_slots(self, state: dict, cfg: dict, wet, W: int, T: int):
        """Every slot's effect over a window of W samples, in the widest
        sub-windows that all effects' rings allow (the whole super-block
        for the reverb).  Returns (the dry-bus contribution [n_dry, W], the
        real-output contribution [n_real, W] or None when no effect wrote
        one); slot state in place."""
        Tw = W
        for slot in self.slots:
            mw = slot.state.max_window()
            while Tw > mw or W % Tw:
                Tw //= 2
        Tw = max(Tw, T)
        dry_parts, real_parts = [], []
        for b in range(W // Tw):
            dry = real = None
            for i, slot in enumerate(self.slots):
                cb, rb, state[f"slot{i}"] = slot.state.process(
                    state[f"slot{i}"], cfg[f"slot{i}"],
                    wet[i, :, b * Tw:(b + 1) * Tw], Tw)
                dry = cb if dry is None else dry + cb
                if rb is not None:
                    real = rb if real is None else real + rb
            dry_parts.append(dry)
            real_parts.append(real)
        # Whether an engine writes the real output is host-known (the
        # device's channels), so every sub-window agrees.
        real = (None if real_parts[0] is None
                else torch.cat(real_parts, dim=1))
        return torch.cat(dry_parts, dim=1), real

    def _direct_accum(self, state: dict, dry, W: int):
        """The dry bus through the HF scale and the baked binaural decode,
        in the voices' accumulation frame."""
        scaled, sp2 = self._hrtf_splitter.hf_scale(
            dry, state["direct_split"], self._direct_hf_scales)
        state["direct_split"].copy_(sp2)
        return hrtf_mix.direct_hrtf_accum(scaled, self._direct_coeffs, W)

    def _decode(self, state: dict, dry):
        """The dry bus [n_dry, T] to the speakers [n_real, T]: the dual-band
        decode (band split, then dec_hf @ hp + dec_lf @ lp), the single-band
        dec_hf @ dry, or for Ambi3D output the bus itself; then the front
        stabilizer.  The products are float32 matmuls at full precision
        (TF32 is off, see _device.resolve_device)."""
        if self.layout.uhj_output or self.layout.tsme_output:
            return self._stereo_encode(state, dry)
        if self._dec_lf is not None:
            hp, lp, sp2 = self._splitter.split(dry, state["split_state"])
            state["split_state"].copy_(sp2)
            out = (torch.matmul(self._dec_hf, hp)
                   + torch.matmul(self._dec_lf, lp))
        elif self._dec_hf is not None:
            out = torch.matmul(self._dec_hf, dry)
        else:
            out = dry
        if self._stab is not None:
            out = self._stabilize(state, out)
        return out

    # cos/sin of pi/6 and pi/8, the stabilizer's LF and HF center pans.
    _STAB_PANS = tuple(float(f32(fn(k * (np.pi * 0.5))))
                       for fn in (np.cos, np.sin) for k in (1 / 3, 1 / 4))

    def _stabilize(self, state: dict, out):
        """Front-image stabilization (alu.cpp:329-405) of the decoded out.
        The direct (real-out prefill) mid/side terms are zero here, this
        renderer having no direct-channel pre-mix, but their all-pass slots
        still evolve as the reference's: zeros through the L slot, the side
        signal through the R slot."""
        li, ri, ci = self._stab["idx"]
        coeff = self._stab["coeff"]
        c_pi_3, c_pi_4, s_pi_3, s_pi_4 = self._STAB_PANS
        side = out[li] - out[ri]
        mid = out[li] + out[ri]
        hf, lf, mid_st = f_ops.band_split(mid[None], state["stab_mid"], coeff)
        state["stab_mid"].copy_(mid_st)
        ap_in = out.clone()
        ap_in[li] = 0.0
        ap_in[ri] = side
        ap_out, ap_z = f_ops.all_pass(ap_in, state["stab_ap"], coeff)
        state["stab_ap"].copy_(ap_z)
        m = lf[0] * c_pi_3 + hf[0] * c_pi_4 + ap_out[li]
        c = lf[0] * s_pi_3 + hf[0] * s_pi_4
        s = ap_out[ri]
        ap_out[li] = (m + s) * 0.5
        ap_out[ri] = (m - s) * 0.5
        ap_out[ci] = ap_out[ci] + c * 0.5
        return ap_out

    def _stereo_encode(self, state: dict, dry):
        """UhjPostProcess / TsmePostProcess (alu.cpp:300): the first-order
        dry bus (UHJ: FuMa2D W, X, Y; TSME: ACN W, Y, Z, X) encoded to
        stereo [2, T] by the IIR tier or the FIR tier that the
        uhj/encode-filter or tsme/encode-filter key selects."""
        T = dry.shape[1]
        if self.layout.uhj_output:
            if self._uhj_enc is not None:
                est = {"wxy": state["uhjenc_wxy"],
                       "jwx_hist": state["uhjenc_jwx_hist"]}
                est2, left, right = self._uhj_enc.encode(
                    est, dry[0], dry[1], dry[2], T)
                state.update({f"uhjenc_{k}": v for k, v in est2.items()})
            else:
                left, right, enc2 = uhj_ops.uhj_encode_iir(
                    dry[0], dry[1], dry[2], state, T)
                state.update(enc2)
        elif self._tsme_enc is not None:
            est = {"wyzx": state["tsmeenc_wyzx"],
                   "jwx_hist": state["tsmeenc_jwx_hist"]}
            est2, left, right = self._tsme_enc.encode(
                est, dry[0], dry[1], dry[2], dry[3], T)
            state.update({f"tsmeenc_{k}": v for k, v in est2.items()})
        else:
            left, right, enc2 = uhj_ops.tsme_encode_iir(
                dry[0], dry[1], dry[2], dry[3], state, T)
            state.update(enc2)
        return torch.stack([left, right])

    # --- UHJ and Super Stereo voices ---

    def _uhj_tier(self, kind: str) -> str:
        """Decode quality for a voice kind: Super Stereo voices use the
        TSME decoder's key when the device output is TSME
        (core/voice.cpp:1232), the UHJ key otherwise."""
        if kind == "ss" and self.layout.tsme_output:
            return self._tsme_dec_q
        return self._uhj_dec_q

    def _uhj_pad(self) -> int:
        """Resample look-ahead of the active decode tiers (the decoder
        input padding, uhjfilter.h:111, rounded to the 128-sample grain)."""
        return max((256 if self._uhj_tier(k) == "fir512" else 128
                    for k, voices in self._uhj_groups.items() if voices),
                   default=0)

    def _uhj_state_spec(self, kind: str) -> list:
        """(field, per-voice shape) of the kind's decode state."""
        if self._uhj_tier(kind) == "iir":
            fields = ["f2dt", "f1s", "f1dt", "f2s"] + (
                ["f1q"] if kind == "u4" else [])
            return [(f, (4, 2)) for f in fields]
        h = uhj_ops.fir_hist(512 if self._uhj_tier(kind) == "fir512"
                             else 256)
        return [("dt_hist", (h,)), ("s_hist", (h,))]

    def _uhj_decode(self, state: dict, cfg: dict, x, T: int, reduce=None):
        """UHJ / Super Stereo source decode (core/voice.cpp:989-995): x
        [L, T + pad] -> [L, T].  Each kind's L/R(/T/Q) rows are gathered,
        decoded batched at the kind's tier, the UHJ2 rows LF-shelved
        (Voice::prepare, core/voice.cpp:1288-1317), and written back over
        their rows as W/X/Y(/Z).  The JAX package gathers and scatters
        with one-hot products, which select the same values exactly.

        With ``reduce`` (x is one shard of the rows), a voice's rows may
        lie on two shards: each shard places the rows it owns
        (``uhj_own_*`` of the gathered rows, at its ``uhj_local_*`` rows)
        into zeros, ``reduce`` sums them over the group, every shard
        decodes the same rows, and writes back only its own."""
        if not any(self._uhj_groups.values()):
            return x[:, :T] if x.shape[1] != T else x
        x_out = x[:, :T].clone()
        for fmt_kind, C, n_in in _UHJ_KINDS.values():
            n = len(self._uhj_groups[fmt_kind])
            if not n:
                continue
            rows = cfg[f"uhj_rows_{fmt_kind}"]
            if reduce is None:
                chans = x.index_select(0, rows)
            else:
                own = cfg[f"uhj_own_{fmt_kind}"]
                rows = cfg[f"uhj_local_{fmt_kind}"]
                chans = x.new_zeros((n * C, x.shape[1])).index_copy_(
                    0, own, x.index_select(0, rows))
                reduce(chans)
            chans = chans.reshape(n, C, x.shape[1])
            tier = self._uhj_tier(fmt_kind)
            fields = [f for f, _ in self._uhj_state_spec(fmt_kind)]
            st = {f: state[f"uhj_{fmt_kind}_{f}"] for f in fields}
            # TSME output devices decode Super Stereo with the reversed
            # phase-shift convention (core/voice.cpp:1232-1251).
            jsgn = -1.0 if (fmt_kind == "ss"
                            and self.layout.tsme_output) else 1.0
            if tier == "iir":
                if fmt_kind == "ss":
                    dec, st2 = uhj_ops.super_stereo_decode_iir(
                        chans, st, cfg["uhj_width"], T, j_sign=jsgn)
                else:
                    dec, st2 = uhj_ops.uhj_decode_iir(chans, st, T, n_in)
            else:
                nfir = 512 if tier == "fir512" else 256
                ch = chans[:, :, :T + uhj_ops.fir_pad(nfir)]
                if fmt_kind == "ss":
                    dec, dh, sh = uhj_ops.super_stereo_decode(
                        ch, st["dt_hist"], st["s_hist"], cfg["uhj_width"],
                        T, nfir, j_sign=jsgn)
                else:
                    dec, dh, sh = uhj_ops.uhj_decode(
                        ch, st["dt_hist"], st["s_hist"], T, n_in, nfir)
                st2 = {"dt_hist": dh, "s_hist": sh}
            for f in fields:
                state[f"uhj_{fmt_kind}_{f}"] = st2[f]
            dec = dec.reshape(n * C, T)
            if fmt_kind == "u2":
                # Only FmtUHJ2 gets the quad-decode LF shelving
                # (sWLFScale/sXYLFScale); Super Stereo does not.
                dec, state["uhj_split"] = self._uhj_splitter.scale(
                    dec, state["uhj_split"], 1.0, cfg["uhj_lf"])
            if reduce is not None:
                dec = dec.index_select(0, own)
            x_out.index_copy_(0, rows, dec)
        return x_out

    def _refresh_uhj_groups(self) -> None:
        """Rebuild the UHJ voice groups, carrying each voice's decode
        state over by identity (a new voice starts from zeros).  After a
        restore the state already holds the groups in voice order."""
        groups = {"u2": [], "u3": [], "u4": [], "ss": []}
        for ctx in self.contexts:
            for v in ctx.voices:
                spec = _UHJ_KINDS.get(v.fmt_channels)
                if spec and v.rows and v.state in (PlayState.PLAYING,
                                                   PlayState.STOPPING):
                    groups[spec[0]].append(v)
        old = groups if self._uhj_adopt else self._uhj_groups
        self._uhj_adopt = False
        if old is not groups and all(
                [id(v) for v in old[k]] == [id(v) for v in groups[k]]
                for k in groups):
            return
        st = self._state
        for k, voices in groups.items():
            for f, shape in self._uhj_state_spec(k):
                name = f"uhj_{k}_{f}"
                self._remap(name, voices, old[k], shape)
        self._remap("uhj_split", groups["u2"], old["u2"], (3, 3))
        if "uhj_split" in st:
            st["uhj_split"] = st["uhj_split"].reshape(-1, 3)
        self._uhj_groups = groups

    def _remap(self, name: str, voices: list, old: list, shape: tuple):
        """state[name] for ``voices`` ([n, *shape]; for uhj_split rows of
        three per voice, [3n, 3]) from its rows for ``old``; absent when
        ``voices`` is empty."""
        st = self._state
        prev = st.pop(name, None)
        if not voices:
            return
        arr = torch.zeros((len(voices),) + shape, dtype=torch.float32,
                          device=self.torch_device)
        if prev is not None:
            prev = prev.reshape((-1,) + shape)
            for i, v in enumerate(voices):
                j = next((j for j, o in enumerate(old) if o is v), None)
                if j is not None and j < prev.shape[0]:
                    arr[i] = prev[j]
        st[name] = arr

    def _uhj_cfg(self, cfg: dict) -> None:
        """The UHJ groups' rows (decoded channel order), the Super Stereo
        widths and the UHJ2 LF shelf gains, on the device."""
        dev = self.torch_device
        for fmt_kind, C, _ in _UHJ_KINDS.values():
            voices = self._uhj_groups[fmt_kind]
            if voices:
                cfg[f"uhj_rows_{fmt_kind}"] = torch.tensor(
                    [r for v in voices for r in v.rows[:C]],
                    dtype=torch.int64, device=dev)
        if self._uhj_groups["ss"]:
            cfg["uhj_width"] = _to_dev(np.array(
                [min(v.props.enh_width, 0.7) for v in self._uhj_groups["ss"]],
                f32), dev)
        if self._uhj_groups["u2"]:
            cfg["uhj_lf"] = _to_dev(np.tile(np.array(_UHJ2_LF, f32),
                                            len(self._uhj_groups["u2"])
                                            )[:, None], dev)

    @staticmethod
    def _advance(cfg: dict, ev: dict, n: int) -> None:
        """End-of-window evolution, in place: positions advance and looping
        voices rebase into [loop_start, loop_end) (congruent mod the loop
        length, so reads are unchanged), setting has_wrapped on a wrap —
        the same integer math as the host mirror (Voice.advance).  Fades
        expire."""
        pi2, pf2 = rs_ops.advance_positions(ev["pos_int"], ev["pos_frac"],
                                            cfg["increment"], n)
        ls, le = cfg["loop_start"], cfg["loop_end"]
        rebase = cfg["has_loop"] & (pi2 >= le)
        ll = torch.clamp(le - ls, min=1)
        ev["pos_int"].copy_(torch.where(
            rebase, ls + torch.remainder(pi2 - ls, ll), pi2))
        ev["pos_frac"].copy_(pf2)
        ev["has_wrapped"] |= rebase
        ev["fade"].zero_()

    def _render_one(self, state: dict, ev: dict, cfg: dict, pool, T: int,
                    kind: str, any_fade: bool, gates: tuple,
                    x_pre=None, reduce=None) -> torch.Tensor:
        """One block: returns out [n_real, T]; state and ev advance in
        place.  ``x_pre`` is this block's slice of a super-block resample;
        without it the block resamples itself.

        ``reduce`` (parallel/sharding.py: state, ev and cfg hold one shard
        of the voice rows) sums a tensor over the shards in place; it
        takes the graph's four cross-voice sums: the UHJ rows, the dry
        bus, the wet buses and the voices' HRTF accumulation.  What follows
        each sum (the effects, the decode, the fold) runs on every shard
        alike, so its state stays whole on each."""
        fade_len = min(GAIN_FADE_SAMPLES, T)
        x = (self._resample(pool, cfg, ev, T + self._uhj_pad(), kind)
             if x_pre is None else x_pre)
        x = torch.where(cfg["active"][:, None], x, 0.0)
        x = self._uhj_decode(state, cfg, x, T, reduce)
        x_mix, x_sends = self._filters(state, ev, cfg, x, gates,
                                       bool(self.slots))
        dry = self._dry_bus(state, ev, cfg, x_mix, fade_len,
                            "gate:nodry" in gates)
        if reduce is not None and dry is not None:
            reduce(dry)
        real = None
        if self.slots:
            wet = self._wet_buses(ev, cfg, x, x_sends, fade_len)
            if reduce is not None:
                reduce(wet)
            contrib, real = self._run_slots(state, cfg, wet, T, T)
            dry = dry + contrib
        if self.layout.mode == panning.RenderMode.HRTF:
            x_cat = torch.cat([state["hrtf_history"], x_mix], dim=1)
            g_eff = torch.where(cfg["playing"], cfg["hrtf_gain"], 0.0)
            y_ext = hrtf_mix.hrtf_voices_accum(
                x_cat, cfg["hrtf_coeffs"], cfg["hrtf_delay"], g_eff,
                cfg["hrtf_old_coeffs"], cfg["hrtf_old_delay"],
                cfg["hrtf_old_gain"], ev["fade"], cfg["active"], T, fade_len,
                any_fade)
            if reduce is not None:
                reduce(y_ext)
            if dry is not None:
                y_ext = y_ext + self._direct_accum(state, dry, T)
            out, new_tail = hrtf_mix.fold_accum(y_ext, state["hrtf_tail"], T)
            state["hrtf_history"].copy_(x_cat[:, T:])
            state["hrtf_tail"].copy_(new_tail)
        else:
            out = self._decode(state, dry)
        if real is not None:
            out = out + real
        self._advance(cfg, ev, T)
        return out

    def _render_super_block(self, state: dict, ev: dict, cfg: dict, pool,
                            T: int, sb: int, kind: str, any_fade: bool,
                            gates: tuple) -> torch.Tensor:
        """sb blocks as ONE resample + ONE [2*192, V] x [V, sb*T] contraction
        + skew-sum + fold (the fused super-block HRTF branch, for scenes
        without filters), with the wet buses, the effects and the dry bus at
        the same width: out [2, sb*T].

        Every fade ramp spans the window's first fade_len samples and holds
        after, exactly the per-block evolution, since fades are nonzero only
        in the first block after a config upload.  x is not masked by
        ``active``: the contractions fold the mask into the gains, and an
        inactive row's history is cleared when the row is reset."""
        W = sb * T
        fade_len = min(GAIN_FADE_SAMPLES, T)
        x_all = self._resample(pool, cfg, ev, W, kind)
        _, x_sends = self._filters(state, ev, cfg, x_all, gates,
                                   bool(self.slots))
        g_eff = torch.where(cfg["playing"], cfg["hrtf_gain"], 0.0)
        y_ext = hrtf_mix.hrtf_voices_accum_split(
            state["hrtf_history"], x_all, cfg["hrtf_coeffs"],
            cfg["hrtf_delay"], g_eff, cfg["hrtf_old_coeffs"],
            cfg["hrtf_old_delay"], cfg["hrtf_old_gain"], ev["fade"],
            cfg["active"], W, fade_len, any_fade)
        contrib = None
        if self.slots:
            wet = self._wet_buses(ev, cfg, x_all, x_sends, fade_len)
            contrib, real = self._run_slots(state, cfg, wet, W, T)
            # HRTF stereo has no front-center or LFE channel: no effect
            # writes the real output here.
            assert real is None, "a real-output effect on HRTF output"
        dry = self._dry_bus(state, ev, cfg, x_all, fade_len,
                            "gate:nodry" in gates)
        if dry is not None:
            if contrib is not None:
                dry = dry + contrib
            y_ext = y_ext + self._direct_accum(state, dry, W)
        out, new_tail = hrtf_mix.fold_accum(y_ext, state["hrtf_tail"], W)
        state["hrtf_history"].copy_(x_all[:, W - hrtf_mix.HIST:])
        state["hrtf_tail"].copy_(new_tail)
        self._advance(cfg, ev, W)
        return out

    def _fused(self, gates: tuple) -> bool:
        """Whether multi-block dispatches may take the fused super-block
        branch: HRTF output, no direct filter, no send filter feeding a
        slot, no NFC."""
        return ("gate:nofilt" in gates
                and (not self.slots or "gate:nosendfilt" in gates)
                and self.layout.mode == panning.RenderMode.HRTF
                and self.nfc is None and self._uhj_pad() == 0)

    def _render_chunk(self, state: dict, ev: dict, cfg: dict, pool, T: int,
                      n_blocks: int, plan: tuple[str, int], resets,
                      any_fade: bool, gates: tuple) -> torch.Tensor:
        """n_blocks consecutive blocks: out [n_blocks, n_real, T] on the
        device.

        ``resets`` ([L] bool, or None) clears re-allocated rows' carried
        memories first; ``any_fade`` is the host's knowledge that some row
        fades in the first block; ``gates`` the scene's _graph_gates."""
        if resets is not None:
            state["filter_z"].masked_fill_(resets[:, None, None], 0.0)
            state["send_filter_z"].masked_fill_(resets[:, None, None, None],
                                                0.0)
            for key in ("hrtf_history", "nfc_z"):
                if key in state:
                    state[key].masked_fill_(resets[:, None], 0.0)
        kind, sb = plan
        out = torch.empty((n_blocks, self.n_real, T), dtype=torch.float32,
                          device=pool.device)
        if sb > 1 and self._fused(gates):
            for i in range(n_blocks // sb):
                o = self._render_super_block(state, ev, cfg, pool, T, sb,
                                             kind, any_fade and i == 0, gates)
                out[i * sb:(i + 1) * sb] = o.reshape(2, sb, T).transpose(0, 1)
        elif sb > 1:
            # One resample per super-block; each block renders its slice,
            # with the UHJ decoders' look-ahead (pad) past its end.
            pad = self._uhj_pad()
            for i in range(n_blocks // sb):
                x_all = self._resample(pool, cfg, ev, sb * T + pad, kind)
                for b in range(sb):
                    out[i * sb + b] = self._render_one(
                        state, ev, cfg, pool, T, kind,
                        any_fade and i == 0 and b == 0, gates,
                        x_pre=x_all[:, b * T:(b + 1) * T + pad])
        else:
            for b in range(n_blocks):
                out[b] = self._render_one(state, ev, cfg, pool, T, kind,
                                          any_fade and b == 0, gates)
        return out

    # --- the render loop ---

    def render_samples(self, num_frames: int) -> np.ndarray:
        """Render num_frames (alcRenderSamplesSOFT, alc/alc.cpp:3498).

        Returns interleaved samples [num_frames, n_real] in the device
        sample type.  The device renders in 128-frame granularity and
        carries any overshoot to the next call."""
        out = np.empty((num_frames, self.n_real), f32)
        done = 0
        with self.lock:
            if self._carry is not None:
                take = min(num_frames, self._carry.shape[0])
                out[:take] = self._carry[:take]
                self._carry = (self._carry[take:]
                               if take < self._carry.shape[0] else None)
                done += take
            while done < num_frames:
                done += self._render_dispatch(out, done, num_frames - done)
            return self._convert_output(out)

    _CHUNK_SIZES = (512, 256, 64, 8, 1)
    _GRAIN = 128  # render granularity: the HRTF fold needs T >= 128

    def _render_dispatch(self, out: np.ndarray, done: int,
                         remaining: int) -> int:
        for ctx in self.contexts:
            ctx.process_updates()

        # Dispatch horizon: the largest chunk that fits both the request
        # and the next host-visible event.  T rounds up to the granularity
        # (128, or an effect's inner chunk size); overshoot goes to carry.
        grain = max([self._GRAIN] + [s.state.granularity for s in self.slots])
        T = min(-(-remaining // grain) * grain, BUFFER_LINE_SIZE)
        n_blocks = 1
        if T == BUFFER_LINE_SIZE:
            horizon = min(remaining // T,
                          min((ctx.event_horizon_blocks(T)
                               for ctx in self.contexts), default=1 << 30))
            for size in self._CHUNK_SIZES:
                if size <= horizon:
                    n_blocks = size
                    break

        ev, any_fade = self._upload()
        gates = self._graph_gates()
        resets = (self._cfg_dev["reset_rows"] if self._cfg_has_resets
                  else None)
        blocks = self._render_chunk(
            self._state, ev, self._cfg_dev,
            self.pool.device_array(self.torch_device), T, n_blocks,
            self._rs_plan(T, n_blocks), resets, any_fade, gates)
        self._cfg_has_resets = False   # the reset mask is consumed
        self._ev_dev, self._ev_fade = ev, False
        # Host bookkeeping overlaps the queued device work: the mirror
        # advance does not read the outputs.
        for ctx in self.contexts:
            ctx.finish_chunk(T, n_blocks)
        self._clock_samples += n_blocks * T
        arr = blocks.cpu().numpy()                         # [n_blocks, C, T]

        frames = n_blocks * T
        flat = arr.transpose(0, 2, 1).reshape(frames, -1)
        served = min(frames, remaining)
        out[done:done + served] = flat[:served]
        if served < frames:
            self._carry = flat[served:].copy()
        return served

    def _upload(self) -> tuple[dict, bool]:
        """Bring ``_cfg_dev`` up to the host table, re-uploading it when a
        host change dropped it.  Returns (the evolving fields on the
        device, the host's knowledge that some row fades in the next
        block)."""
        if self._cfg_dev is None:
            # The config (and the evolving fields) re-upload from the host
            # table: every context's row mirror must be current.
            for ctx in self.contexts:
                if not ctx._packed_this_update:
                    ctx._pack_block_fields(BUFFER_LINE_SIZE)
                    ctx._packed_this_update = True
            self._refresh_uhj_groups()
            cfg = self._cfg_from_table()
            self._uhj_cfg(cfg)
            mask = self._pending_resets_mask()
            self._cfg_has_resets = bool(mask.any())   # host-known
            cfg["reset_rows"] = _to_dev(mask, self.torch_device)
            for i, slot in enumerate(self.slots):
                params = slot.compute_update()
                keys = slot.state.device_params or tuple(params)
                cfg[f"slot{i}"] = {k: _to_dev(params[k], self.torch_device)
                                   for k in keys if k in params}
            self._cfg_dev = cfg
            # Evolving fields changed with the config; in steady state the
            # device's own evolved copy equals the host mirror.
            self._ev_dev = None
        if self._ev_dev is None:
            return (self.table.evolving_dict(self.torch_device),
                    bool(self.table.fade.any()))
        return self._ev_dev, self._ev_fade

    def _cfg_from_table(self) -> dict:
        """Upload the host ParamTable as the device config dict, with the
        unit kernel's constant per-voice tap weights (valid whenever the
        unit plan is selected: pos_frac is invariant at unit increment).
        With NFC, nfc_w0 becomes per-row filter coefficients on the host
        (NfcFilterAdjust, nfc.cpp:75-222); -1 rows get the create-state
        identity filter."""
        dev = self.torch_device
        cfg = {k: _to_dev(getattr(self.table, k), dev)
               for k in ParamTable._CONFIG if k != "nfc_w0"}
        t = self.table
        cfg["rs_unit_w"] = _to_dev(rs_unit.unit_weights_np(
            self._bank, t.bank_row, t.sf, t.pos_frac, self._taps), dev)
        self._pool_extent_bytes = self._pool_extent()
        if self.nfc is not None:
            cfg["nfc_coeffs"] = _to_dev(np.where(
                (t.nfc_w0 < 0.0)[:, None], self.nfc.identity_coeffs(1),
                self.nfc.adjust(np.maximum(t.nfc_w0, 0.0))), dev)
        return cfg

    # --- checkpoint / resume ---

    def snapshot(self) -> dict:
        """Serializable checkpoint at a block boundary, in the layout of the
        JAX package's RenderDevice.snapshot(): numpy ``state``, ``ev``,
        ``table``, ``carry`` and ``clock``."""
        with self.lock:
            ev = (self._ev_dev if self._ev_dev is not None
                  else self.table.evolving_dict(self.torch_device))
            return {
                "state": _state_to_host(self._state),
                "ev": {k: _to_host(v) for k, v in ev.items()},
                "table": {k: np.asarray(getattr(self.table, k)).copy()
                          for k in ParamTable._FIELDS},
                "carry": None if self._carry is None else self._carry.copy(),
                "clock": self._clock_samples,
            }

    def restore(self, snap: dict) -> None:
        """Continue a snapshot — this port's or the JAX package's
        RenderDevice.snapshot(), effect-slot state included — in this
        identically configured device."""
        with self.lock:
            for k, v in snap["table"].items():
                getattr(self.table, k)[...] = v
            dev = self.torch_device
            self._state = _state_to_dev(snap["state"], dev)
            self._ev_dev = {k: _to_dev(v, dev) for k, v in snap["ev"].items()}
            self._ev_fade = bool(np.any(snap["ev"]["fade"]))
            self._carry = (None if snap["carry"] is None
                           else np.array(snap["carry"], f32))
            self._clock_samples = int(snap["clock"])
            self._uhj_adopt = True
            self._cfg_dev = None

    def handle_disconnect(self, msg: str = "") -> None:
        """Backend/device loss (doDisconnect, alc/alu.cpp:2499-2533).

        Marks the device disconnected, posts a disconnect event to every
        context, and stops all playing voices unless a context holds them
        (AL_SOFTX_hold_on_disconnect, core/context.h:94)."""
        with self.lock:
            if not self.connected:
                return
            self.connected = False
            log.err("device disconnected: %s", msg)
            for ctx in self.contexts:
                ctx._emit("disconnected", 0, msg)
                if getattr(ctx, "hold_on_disconnect", False):
                    continue
                for v in ctx.voices:
                    if v.source_id:
                        src = ctx.sources.get(v.source_id)
                        if src is not None:
                            src.voice_ended()
                        v.source_id = 0
                    if v.state == PlayState.PLAYING:
                        v.state = PlayState.STOPPING
                        self.mark_config_dirty()

    def clock_ns(self) -> int:
        """ALC_DEVICE_CLOCK_SOFT: nanoseconds of samples rendered."""
        return int(self._clock_samples * 1_000_000_000 // self.sample_rate)

    def clock_latency_ns(self) -> tuple[int, int]:
        """ALC_DEVICE_CLOCK_LATENCY_SOFT: (clock, latency) — the loopback
        latency is the rendered-ahead carry."""
        carry = self._carry.shape[0] if self._carry is not None else 0
        return self.clock_ns(), int(carry * 1_000_000_000
                                    // self.sample_rate)

    def mark_config_dirty(self) -> None:
        self._cfg_dev = None

    def _pending_resets_mask(self) -> np.ndarray:
        mask = np.zeros(self.capacity, bool)
        if self._pending_resets:
            mask[list(self._pending_resets)] = True
            self._pending_resets.clear()
        return mask

    # --- host output stage ---

    def _apply_distance_comp(self, x: np.ndarray) -> np.ndarray:
        """Per-channel delay + gain (DistanceComp::process analog), carrying
        each channel's last `delay` samples across calls."""
        delays, gains, bufs = self._dist_comp
        n = x.shape[0]
        for c in range(x.shape[1]):
            d = int(delays[c])
            if d == 0:
                if gains[c] != 1.0:
                    x[:, c] = (x[:, c] * gains[c]).astype(f32)
                continue
            col = x[:, c].copy()
            if n >= d:
                x[d:, c] = col[:n - d]
                x[:d, c] = bufs[c]
                bufs[c][:] = col[n - d:]
            else:
                x[:, c] = bufs[c][:n]
                bufs[c][:d - n] = bufs[c][n:]
                bufs[c][d - n:] = col
            x[:, c] = (x[:, c] * gains[c]).astype(f32)
        return x

    def _convert_output(self, x: np.ndarray) -> np.ndarray:
        """Limiter -> dither -> Write<T> quantization (alu.cpp:2422-2438),
        in <=1024-frame blocks on the host output."""
        if self._bs2b is not None:
            left, right = self._bs2b.cross_feed(x[:, 0], x[:, 1])
            x = np.stack([left, right], axis=1)
        if self._dist_comp is not None:
            x = self._apply_distance_comp(np.ascontiguousarray(x))
        if self._volume_scale is not None:
            x = (x * f32(self._volume_scale)).astype(f32)
        if self.limiter is not None:
            x = np.ascontiguousarray(x)
            for i in range(0, x.shape[0], BUFFER_LINE_SIZE):
                self.limiter.process(x[i:i + BUFFER_LINE_SIZE])
        if self.dither is not None:
            parts = [self.dither.apply(x[i:i + BUFFER_LINE_SIZE])
                     for i in range(0, x.shape[0], BUFFER_LINE_SIZE)]
            x = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        if self.fmt_type == DevFmtType.FLOAT:
            return x
        # SampleConv<T> (alu.cpp:2320-2346): clamp then round-nearest-even.
        if self.fmt_type == DevFmtType.SHORT:
            return np.rint(np.clip(x * f32(32768.0), -32768.0, 32767.0)
                           ).astype(np.int16)
        if self.fmt_type == DevFmtType.UBYTE:
            return (np.rint(np.clip(x * f32(128.0), -128.0, 127.0)
                            ).astype(np.int16) + 128).astype(np.uint8)
        if self.fmt_type == DevFmtType.BYTE:
            return np.rint(np.clip(x * f32(128.0), -128.0, 127.0)
                           ).astype(np.int8)
        if self.fmt_type == DevFmtType.INT:
            return np.rint(np.clip(x * f32(2147483648.0), -2147483648.0,
                                   2147483520.0)).astype(np.int64
                                                         ).astype(np.int32)
        raise NotImplementedError(self.fmt_type)
