#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openal_soft_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero and prints no
result:

  1. env        the card (nvidia-smi name and power limit), torch and CUDA
  2. build      nvcc builds every kernel from csrc/, all at once, with each
                kernel's registers and spills (-Xptxas -v); beside them g++
                and gcc build the C ABI (libopenal_torch.so, test_shim,
                scene_client) and the output limiter
  3. kernel     resample_unit against its plain version on voices with loop
                seams, short loops, backward wraps, end clamps, pre-start
                silence and empty sources; then UNIT_CASES: ragged W (1,
                100, 1023, 16385) with buffers at the pool's end, loops of
                1-3 frames wrapped and not, taps 1, 4 and 48: bit-equal
                required
  4. timing     resample_unit at the main path's shape [4096, 16384] and at
                one block [4096, 1024]: the kernel alone beside the
                previous kernel where the build directory holds its source
                (parent/resample_unit.cu; previous, new, new, previous, 20
                launches each, CUDA events), through its wrapper, and its
                plain version; at 16384 also resample_gen alone on the same
                voices at increment 1<<16 (the same function)
  5. best_case  bench.py's best_case scene at full width: 4096 looping HRTF
                voices, 48 one-second tones, 512 blocks of 1024 frames per
                call; the output must be finite and nonzero
  6. parity     best_case at 64 voices on the card against the CPU: fused
                (8192 frames), per-block (4096) and odd sizes, <= 1e-5
  7. kernel     resample_gen against its plain version: every tier (taps 1,
                2, 4, 24, 48), increments 0.25x..10x, the same branch cases
                as phase 3; then WINDOW_CASES: ragged W (1, 100, 1023,
                16385), taps 48 at 10x (the largest window and weight
                tables), loops of 1-3 frames wrapped and not: bit-equal
                required
  8. kernel     reverb against its plain version at 44.1, 48 and 96 kHz,
                one pipeline and the A/B crossfade, windows of 1024 and
                16384, >= 128 chunks each including the decaying tail, with
                chunk k+1's early half beside chunk k's late half; the
                in-order schedule; density 0 and 1 with late_reverb_delay 0
                and 0.1 s: bit-equal and <= 1e-6 required
  9. timing     resample_gen at the loaded scene's shape, the kernel alone
                beside the previous kernel where the build directory holds
                its source (parent/resample_gen.cu; previous, new, new,
                previous, 20 launches each, CUDA events), through its
                wrapper, and its plain version; reverb per window at
                W = 16384 and 1024 (device time), beside the previous
                kernel's where the build directory holds its source
                (parent/reverb.cu)
 10. loaded     bench.py's loaded scene at full width: 4096 voices at pitch
                2**U(-1,1), one EAXReverb slot on send 0, 512-block calls;
                the output must be finite and nonzero
 11. parity     loaded at 64 voices on the card against the CPU: fused
                (8192 frames), per-block (4096) and odd sizes, <= 1e-4
 12. kernel     biquad against its plain version: V 100 and 256, T 128,
                1024 and 16384, counters 0, 256 and mixed, lowpass,
                highpass, bandpass and unfiltered rows, state carried over
                two calls; 1-3 paths over one input with mixed active masks,
                state in place, V 100 and 4097, T 32, 1024 and 16384; the
                UHJ four-section all-pass cascades at 3, 24 and 48 rows:
                bit-equal required
 13. timing     biquad (device time) at V=4096, T=1024 as the device calls
                it (three masked paths), one path at T=1024 and 16384, the
                UHJ cascades at 24 and 3 rows, beside the previous kernel's
                where the build directory holds its source
                (parent/biquad.cu); the chain's floor from the kernel's
                probe
 14. speakers_filtered  the loaded scene on a stereo speaker device
                (pairwise panning), every voice behind a lowpass direct
                filter of gain_hf ~ U(0.1, 0.9), send 0 through a lowpass
                send filter of gain_hf 0.5; one warm call, then new gains
                for every voice and two timed 512-block calls; the output
                must be finite and nonzero
 15. parity     at 64 voices on the card against the CPU, <= 1e-4: the
                stereo scene of phase 14, a surround51 scene (dual-band
                decode, front stabilizer), an HRTF scene with direct
                filters and an order-2 Ambi3D scene with NFC; multi-block
                (8192 frames), per-block (4096) and odd sizes
 16. kernel     resample_span against its plain version: V 256; W 128,
                1024, 1152, 16512 and 16640; taps 1, 2, 4, 24 and 48;
                increments 0.25x..10x; the branch cases of phase 3 and
                windows at the pool's end; then WINDOW_CASES as phase 7:
                bit-equal required
 17. kernel     resample_voice against its plain version, loops shorter
                than the window included; then VOICE_CASES: WINDOW_CASES's
                shapes within its largest bucket: bit-equal required
 18. timing     resample_span, resample_gen and resample_voice and their
                plain versions at [4096, 16512] on a 268 MB pool,
                resample_voice also at [4096, 1024], and resample_span and
                resample_gen at the loaded scene's [4096, 16384] on its
                9.2 MB pool (CUDA events): each kernel alone beside its
                previous kernel as in phase 9 (parent/resample_voice.cu
                and the others), and through its wrapper
 19. uhj_big_pool  4096 looping mono voices at pitch 2**U(-1,1) over 1024
                distinct 4-second buffers, 16 UHJ2 ambience beds and 8
                Super Stereo stems of 20 s, on a UHJ stereo device: a
                ~970 MB pool, 19x the card's L2; resample_span must launch
                and resample_gen must not; the output must be finite and
                nonzero
 20. parity     at 64 voices on the card against the CPU, <= 1e-4: a UHJ
                scene on a 98 MB pool (the span kernel), TSME output with
                Super Stereo voices, UHJ3 and UHJ4 voices at the FIR256
                decoder and FIR512 encoder, and UHJ2 and Super Stereo
                voices at the FIR512 decoder and FIR256 encoder

 21. kernel     effect_scan against its plain version: each entry at T 128,
                1024 and 16384 and B 1, 4 and 9, the compressor on and off,
                the autowah's attack above and below its release, swept
                coefficients crossing the 0.46 clamp of w0, state carried
                over two calls: bit-equal required
 22. kernel     biquad in the effects' shapes: the equalizer's four-section
                cascade at B 4 and 9, one section beside an identity
                section at 4T = 4096: bit-equal required
 23. timing     effect_scan's entries alone (CUDA events, beside
                parent/effect_scan.cu where the build directory holds it)
                and through their wrappers at B 4 and 9, T 1024 and 16384,
                with the chain floor; the plain versions at T 1024
 24. fx_rack    a game's EFX zones on 5.1 speakers: 4096 looping voices at
                pitch 2**U(-1,1), 15 slots (every engine of the registry
                but null and reverb), send 0 of voice v to engine v mod
                14, send 1 to the EAXReverb slot (an order-2 decoder); one
                warm and one timed 512-block call, device operations per
                block; finite, nonzero, FC and LFE nonzero; effect_scan,
                resample_gen, reverb and biquad must launch
 25. parity     each engine at 64 voices on the card against the CPU on
                stereo, the dedicated engines also on surround51, the
                equalizer, echo and pitch shifter on HRTF (the fused
                branch), 8192 and 4096 frames: <= 1e-4 (1e-3 with the
                pitch shifter)
 26. api        best_case and speakers_filtered at 4096 voices built only
                through openal_soft_tpu_torch.al.api (bench_scene's seed
                and draw order), a warm and a timed 512-block
                alcRenderSamplesSOFT call each, bit-equal to bench_scene's
                builds of the same scenes; no AL error, every source
                AL_PLAYING with its AL_SAMPLE_OFFSET advanced, the device
                clock equal to the frames rendered; the build's wall time
                and x realtime through the API and directly
 27. eax        the API speakers_filtered scene with EAX 2.0 (hangar,
                -1200 mB occlusion on every other source) at 4096 voices:
                finite and unlike the scene without EAX; at 64 voices the
                card against the CPU, <= 1e-4
 28. playback   the wave writer through alcOpenDevice (ALC_MONO_SOURCES
                4096) with the API speakers_filtered scene: 8 periods of
                1024 frames with pause and resume between them, bit-equal
                to a loopback device's render in the same calls; after
                alcResetDeviceSOFT every source plays on, on the card,
                connected; the null output's thread for ~2 s (its share of
                realtime); handle_disconnect: ALC_CONNECTED 0, the event
                delivered, every voice stopped
 29. uhj_tools  a seeded 120-s 48 kHz FuMa B-Format track: the UHJ encoder's
                command line at iir (biquad must launch), encode() at
                fir256 and fir512, the iir result through the decoder's
                command line at fir256 and fir512; every output finite,
                nonzero, full length; the head of each (2 s at iir, 10 s
                otherwise) on the card against the CPU, <= UHJ_TOL; wall
                time and x realtime per tier
 30. makemhr    a seeded HRIR set on the MIT KEMAR grid (44.1 kHz, 512 taps,
                19 elevations, 828 directions, measured from -40 degrees:
                710 HRIRs, the gap synthesized) through process_hrir_set
                at the module's defaults into an .mhr, selected through
                alsoft.conf (hrtf-paths, default-hrtf); best_case at 4096
                voices on it, a warm and a timed 512-block call:
                resample_unit must launch, the output finite, nonzero and
                unlike the default data set's; makemhr's host seconds
 31. openal_info  the lister's command line on the card: exit 0, the card's
                name, 17 effects, 113 presets
 32. c_abi      test_shim on the card (capture from a fake libasound): PEAK=,
                STREAM_PEAK=, CAPTURED=, EAX_DECAY=; best_case at 4096
                voices built through the C ABI from phase 26's seed and
                draw order by the C program scene_client and by this
                process through the same library (ctypes), each bit-equal
                to the al.api build over a warm and a timed 512-block
                call, resample_unit launched in the ctypes call; build time
                and x realtime through C and Python; the int16 output's
                limiter is the native library
 33. examples   the 14 examples' main() on the card, <= 2 s of audio, a
                seeded WAV and LAF file as inputs; every WAV written is
                nonzero; alreverb and almultireverb launch the reverb
 34. sharding   the loaded scene at full width plus a UHJ2 bed across the
                shards' boundary (capacity 4100) through
                parallel/sharding.py, 8 carried 1024-frame blocks: world 1
                over NCCL in a spawned process, bit-equal to the unsharded
                graph (out, filter_z, hrtf_history, hrtf_tail, pos_int);
                world 2 over gloo on CUDA tensors (two processes on the
                one card) within 1e-5 x max(1, peak) of it, resample_gen,
                reverb and biquad launched on each rank; wall ms per block
                of each; then dryrun_multichip(1) at its defaults

Every kernel's launch count is set to 0 just before its scene's timed call
and must have grown just after it.  Then the kernels' JSON line, the card's
nvidia-smi line, and last {"ok": true, "device": {...}}.  Exits non-zero at
once when torch.cuda.is_available() is false.

    python3 chip_smoke.py --profile best_case|loaded|speakers_filtered|uhj_big_pool|fx_rack

instead builds the kernels and profiles one warm 512-block call of the
scene at full width with torch.profiler (device time by kernel and by op;
fx_rack's profile records 16 blocks after an unprofiled 512-block call).
``--seed N`` (default 0) seeds fx_rack's voices and its convolution IR.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

RATE = 48000
BLOCK = 1024
CHUNK_BLOCKS = 512
N_VOICES = 4096
N_TONES = 48
PARITY_TOL = 1e-5          # best_case: no feedback path
LOADED_TOL = 1e-4          # loaded: the reverb carries rounding forward
REVERB_TOL = 1e-6          # reverb kernel vs its plain version
SPEAKERS_TOL = 1e-4        # filtered scenes with a slot, as LOADED_TOL
UHJ_TOL = 1e-4             # UHJ scenes: the IIR all-passes feed back
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
FX_TOL = 1e-4              # effect parity, the engines' golden budget
FX_PSHIFT_TOL = 1e-3       # the pitch shifter's bin pick can flip
KERNELS = ("resample_unit", "resample_gen", "reverb", "biquad",
           "resample_span", "resample_voice", "effect_scan")
REPLACES = {
    "resample_unit": "openal_soft_tpu/ops/pallas/resample_unit.py:284",
    "resample_gen": "openal_soft_tpu/ops/pallas/resample3.py:113",
    "reverb": "openal_soft_tpu/ops/pallas/reverb.py:219",
    "biquad": "openal_soft_tpu/ops/pallas/biquad.py:35",
    "resample_span": "openal_soft_tpu/ops/pallas/resample2.py:93",
    "resample_voice": "openal_soft_tpu/ops/pallas/resample.py:62",
    "effect_scan": "no TPU kernel: the lax.scan recurrences of "
                   "openal_soft_tpu/effects/compressor.py:49 and "
                   "autowah.py:55,77",
}


class EffectScanCount:
    """effect_scan's launch count: the sum of its three entries' counts
    (``ops/kernels/effect_scan.py``); setting it to 0 resets all three."""

    @property
    def launches(self) -> int:
        from openal_soft_tpu_torch.ops.kernels import effect_scan as es
        return es.launches()

    @launches.setter
    def launches(self, value: int) -> None:
        from openal_soft_tpu_torch.ops.kernels import effect_scan as es
        if value != 0:
            raise ValueError("the count can only be reset to 0")
        es.reset_launches()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def tone_pool(n_tones: int) -> list[np.ndarray]:
    t = np.arange(RATE) / RATE
    return [(0.1 * np.sin(2 * np.pi * 110.0 * 2.0 ** (fi / 12.0) * t)
             ).astype(np.float32) for fi in range(n_tones)]


def bench_scene(n_voices: int, capacity: int, device: str,
                loaded: bool = False, filtered: bool = False,
                channels: str = "stereo", hrtf: bool = True,
                uhj_at: int | None = None, **dev_kw):
    """bench.py's scenes on the port (seed 42, positions x3.0, 48 tones):
    best_case, or loaded (pitch 2**U(-1,1), one EAXReverb slot, send 0).
    ``filtered`` puts a lowpass AL_DIRECT_FILTER of gain_hf ~ U(0.1, 0.9)
    on every voice and, with the slot, a lowpass send filter of gain_hf
    0.5 on send 0.  With ``uhj_at``, a looping one-second UHJ2 bed starts
    before voice ``uhj_at``, on the three rows after that voice's."""
    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    dev = LoopbackDevice(frequency=RATE, channels=channels,
                         sample_type="float32", capacity=capacity,
                         hrtf=hrtf, device=device, **dev_kw)
    ctx = dev.create_context()
    slot = send_flt = None
    if loaded:
        slot = ctx.create_aux_slot()
        slot.set_effect(ctx.create_effect("eaxreverb"))
        if filtered:
            send_flt = ctx.create_filter("lowpass")
            send_flt.set("gain_hf", 0.5)
    rng = np.random.default_rng(42)
    bufs = []
    for tone in tone_pool(N_TONES):
        buf = ctx.create_buffer()
        buf.set_data(tone, "mono", "float32", RATE)
        bufs.append(buf)
    for i in range(n_voices):
        if i == uhj_at:
            bed = ctx.create_buffer()
            t = np.arange(RATE) / RATE
            bed.set_data(np.stack([0.3 * np.sin(2 * np.pi * 330 * t),
                                   0.25 * np.sin(2 * np.pi * 550 * t + 1.0)],
                                  axis=1).ravel().astype(np.float32),
                         "uhj2", "float32", RATE)
            src = ctx.create_source()
            src.buffer(bed)
            src.looping = True
            src.play()
        src = ctx.create_source()
        src.buffer(bufs[i % N_TONES])
        src.looping = True
        src.set("position", tuple(rng.standard_normal(3) * 3.0))
        if loaded:
            src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
            src.send(slot, 0, send_flt)
        if filtered:
            set_direct_lowpass(ctx, src, float(rng.uniform(0.1, 0.9)))
        src.play()
    return dev


# EFX enums (AL/efx.h) that the API scenes use beside the api module's.
AL_FILTER_LOWPASS = 0x0001
AL_LOWPASS_GAINHF = 0x0002
AL_EFFECT_EAXREVERB = 0x8000


def api_open_loopback(capacity: int, device: str, channels: str = "stereo",
                      hrtf: bool = True, **dev_kw):
    """bench_scene's device, opened through alcLoopbackOpenDeviceSOFT."""
    from openal_soft_tpu_torch.al import api as al

    return al.alcLoopbackOpenDeviceSOFT(RATE, channels, "float32",
                                        hrtf=hrtf, capacity=capacity,
                                        device=device, **dev_kw)


def api_scene(dev, n_voices: int, loaded: bool = False,
              filtered: bool = False):
    """bench_scene's scene on an open device (loopback or playback), built
    only through the port's AL/ALC entry points with bench_scene's seed
    and draw order.  Returns the context and the source ids."""
    from openal_soft_tpu_torch.al import api as al

    ctx = al.alcCreateContext(dev)
    al.alcMakeContextCurrent(ctx)
    slot = send_flt = 0
    if loaded:
        slot = al.alGenAuxiliaryEffectSlots()
        eff = al.alGenEffects()
        al.alEffecti(eff, al.AL_EFFECT_TYPE, AL_EFFECT_EAXREVERB)
        al.alAuxiliaryEffectSloti(slot, al.AL_EFFECTSLOT_EFFECT, eff)
        if filtered:
            send_flt = al.alGenFilters()
            al.alFilteri(send_flt, al.AL_FILTER_TYPE, AL_FILTER_LOWPASS)
            al.alFilterf(send_flt, AL_LOWPASS_GAINHF, 0.5)
    rng = np.random.default_rng(42)
    bufs = []
    for tone in tone_pool(N_TONES):
        bid = al.alGenBuffers()
        al.alBufferData(bid, al.AL_FORMAT_MONO_FLOAT32, tone, RATE)
        bufs.append(bid)
    sids = []
    for i in range(n_voices):
        pos = rng.standard_normal(3) * 3.0
        pitch = float(2.0 ** rng.uniform(-1, 1)) if loaded else None
        gain_hf = float(rng.uniform(0.1, 0.9)) if filtered else None
        sid = al.alGenSources()
        al.alSourcei(sid, al.AL_BUFFER, bufs[i % N_TONES])
        al.alSourcei(sid, al.AL_LOOPING, al.AL_TRUE)
        if filtered:
            flt = al.alGenFilters()
            al.alFilteri(flt, al.AL_FILTER_TYPE, AL_FILTER_LOWPASS)
            al.alFilterf(flt, AL_LOWPASS_GAINHF, gain_hf)
            al.alSourcei(sid, al.AL_DIRECT_FILTER, flt)
        al.alSource3f(sid, al.AL_POSITION, *pos)
        if loaded:
            al.alSourcef(sid, al.AL_PITCH, pitch)
            al.alSource3i(sid, al.AL_AUXILIARY_SEND_FILTER, slot, 0,
                          send_flt)
        al.alSourcePlay(sid)
        sids.append(sid)
    return ctx, sids


def set_direct_lowpass(ctx, src, gain_hf: float) -> None:
    flt = ctx.create_filter("lowpass")
    flt.set("gain_hf", gain_hf)
    src.direct_filter(flt)


def refilter(dev, rng) -> None:
    """A new direct gain_hf ~ U(0.1, 0.9) for every voice: the next
    block's filters interpolate toward it."""
    for ctx in dev.contexts:
        for src in ctx.sources.values():
            set_direct_lowpass(ctx, src, float(rng.uniform(0.1, 0.9)))


# A dual-band decoder for surround51 that leaves the center silent, so the
# front stabilizer engages (the matrices of the stock itu5.1 preset, the
# CE rows zeroed).
NOCENTER51 = """/description     dual-band itu5.1 without center
/version         3
/dec/chan_mask   11b
/dec/freq_bands  2
/dec/speakers    5
/dec/coeff_scale fuma
/opt/xover_freq  400.000000
/opt/xover_ratio 0.000000
/speakers/{
add_spkr LS 1.0  110.0 0.0
add_spkr LF 1.0   30.0 0.0
add_spkr CE 1.0    0.0 0.0
add_spkr RF 1.0  -30.0 0.0
add_spkr RS 1.0 -110.0 0.0
/}
/lfmatrix/{
order_gain 1.0 1.0 1.0 0.0
add_row  4.9010985e-1  3.7730501e-1 -3.7310699e-1 -1.2591453e-1  1.4513300e-2
add_row  1.4908573e-1  3.0356168e-1  1.5329006e-1  2.4511248e-1 -1.5075313e-1
add_row  0.0 0.0 0.0 0.0 0.0
add_row  1.4908573e-1 -3.0356168e-1  1.5329006e-1 -2.4511248e-1 -1.5075313e-1
add_row  4.9010985e-1 -3.7730501e-1 -3.7310699e-1  1.2591453e-1  1.4513300e-2
/}
/hfmatrix/{
order_gain 1.0 1.0 1.0 0.0
add_row  5.6731600e-1  4.2292000e-1 -3.1549500e-1 -6.3449000e-2 -2.9238000e-2
add_row  3.6858400e-1  2.7234900e-1  3.2161600e-1  1.9264500e-1  4.8260000e-2
add_row  0.0 0.0 0.0 0.0 0.0
add_row  3.6858400e-1 -2.7234900e-1  3.2161600e-1 -1.9264500e-1  4.8260000e-2
add_row  5.6731600e-1 -4.2292000e-1 -3.1549500e-1  6.3449000e-2 -2.9238000e-2
/}
/end
"""
# The parity scenes of phase 15: bench_scene arguments and alsoft.conf.
# The second-order outputs carry no slot: the reverb's upmix to buses above
# first order fails in the JAX package and the port alike (ROADMAP C9).
SPEAKER_SCENES = {
    "stereo": ({"channels": "stereo", "hrtf": False, "loaded": True}, ""),
    "surround51": ({"channels": "surround51", "hrtf": False},
                   "front-stablizer = true\n[decoder]\n"
                   "surround51 = {dir}/nocenter51.ambdec\n"),
    "hrtf": ({"channels": "stereo", "hrtf": True, "loaded": True}, ""),
    "ambi3d": ({"channels": "ambi3d", "hrtf": False, "ambi_order": 2},
               "[decoder]\nnfc = true\nspeaker-dist = 1.5\n"),
}


@contextlib.contextmanager
def alsoft_conf(text: str):
    """The port reads ``text`` as its alsoft.conf (``{dir}`` names a
    temporary directory that also holds NOCENTER51) within the scope."""
    from openal_soft_tpu_torch.alc import config as alconf

    old = os.environ.get("ALSOFT_CONF")
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "nocenter51.ambdec"), "w") as fh:
            fh.write(NOCENTER51)
        path = os.path.join(d, "alsoft.conf")
        with open(path, "w") as fh:
            fh.write(text.format(dir=d))
        os.environ["ALSOFT_CONF"] = path
        alconf.load_config(reload=True)
        try:
            yield
        finally:
            if old is None:
                del os.environ["ALSOFT_CONF"]
            else:
                os.environ["ALSOFT_CONF"] = old
            alconf.load_config(reload=True)


def speaker_scene(name: str, n_voices: int, device: str):
    """A phase-15 scene: bench_scene with filters on the output ``name`` of
    SPEAKER_SCENES."""
    kw, conf = SPEAKER_SCENES[name]
    with alsoft_conf(conf):
        return bench_scene(n_voices, n_voices, device, filtered=True, **kw)


def unit_case(rng, V: int, W: int, taps: int, device):
    """Inputs for the unit kernel covering every resolve branch: loop seam
    inside the window, short loops (several seams), backward wrap of the
    history, non-looping end clamp, pre-start silence, empty sources."""
    import torch

    lens = rng.integers(W // 2 + 64, 3 * W + 4096, V)
    pool_len = int(lens.sum()) + 4096
    pool = rng.standard_normal(pool_len).astype(np.float32)
    off = np.concatenate([[8], 8 + np.cumsum(lens[:-1])])
    ls = rng.integers(0, lens // 4)
    le = ls + rng.integers(1, lens - ls + 1)
    has_loop = np.zeros(V, bool)
    has_wrapped = np.zeros(V, bool)
    pos = rng.integers(0, lens)
    kind = np.arange(V) % 8
    seam = kind == 0                  # loop seam inside the window
    has_loop[seam] = True
    pos[seam] = np.maximum(le[seam] - W // 2, ls[seam])
    short = kind == 1                 # loops shorter than the window
    has_loop[short] = True
    le[short] = ls[short] + rng.integers(1, max(W // 4, 2), short.sum())
    pos[short] = ls[short]
    back = kind == 2                  # wrapped: history wraps backward
    has_loop[back] = has_wrapped[back] = True
    pos[back] = ls[back] + rng.integers(0, taps + 1, back.sum())
    clamp = kind == 3                 # non-looping end clamp
    pos[clamp] = lens[clamp] - W // 3
    pre = kind == 4                   # delayed start: silence before 0
    pos[pre] = -rng.integers(1, W // 2 + taps + 2, pre.sum())
    empty = kind == 5                 # src_len == 0
    lens[empty] = 0
    has_loop[kind == 6] = True        # looping, seam outside the window
    T = lambda a, dt=torch.int32: torch.tensor(np.asarray(a), device=device
                                               ).to(dt)
    w = rng.standard_normal((V, taps)).astype(np.float32)
    return (T(pool, torch.float32), T(off), T(lens), T(ls), T(le),
            T(has_loop, torch.bool), T(has_wrapped, torch.bool), T(pos),
            T(w, torch.float32))


def gen_case(rng, V: int, W: int, taps: int, max_inc: int, device):
    """Inputs for the general kernel: unit_case's voices and branch cases
    at increments from 0.25x to max_inc (16.16), with random phases,
    resampler rows and scales, and the global weight bank."""
    import torch

    from openal_soft_tpu_torch.ops import tables

    (pool, off, lens, ls, le, has_loop, has_wrapped, pos,
     _) = unit_case(rng, V, W, taps, device)
    inc = rng.integers(1 << 14, max_inc + 1, V)
    # Keep (W-1)*inc + 65535 < 2**31 as the device's plan does.
    inc = np.minimum(inc, ((1 << 31) - 65536) // max(W - 1, 1))
    Ti = lambda a: torch.tensor(np.asarray(a), device=device).to(torch.int32)
    bank = {k: torch.tensor(v, device=device)
            for k, v in tables.weight_bank().items()}
    return (pool, off, lens, ls, le, has_loop, has_wrapped, pos,
            Ti(rng.integers(0, 1 << 16, V)), Ti(inc),
            Ti(rng.integers(0, 52, V)),
            torch.tensor(rng.random(V).astype(np.float32), device=device),
            bank)


def filter_coeffs(gain_hf: float, gain_lf: float,
                  rate: int = RATE) -> np.ndarray:
    """[2, 5] the port's host coefficients of an EFX filter on a voice
    path (alu.cpp:1615-1652): a high shelf at the 5 kHz HF reference
    (lowpass, bandpass) cascaded with a low shelf at the 250 Hz LF
    reference (highpass, bandpass; its poles sit near DC)."""
    from openal_soft_tpu_torch.core.context import _rcpq_from_slope
    from openal_soft_tpu_torch.ops import spec

    hf = np.float32(max(gain_hf, 0.001))
    lf = np.float32(max(gain_lf, 0.001))
    return np.stack([
        spec.biquad_set_params("highshelf", np.float32(5000.0 / rate), hf,
                               _rcpq_from_slope(hf, 1.0)),
        spec.biquad_set_params("lowshelf", np.float32(250.0 / rate), lf,
                               _rcpq_from_slope(lf, 1.0))]).astype(np.float32)


def biquad_case(rng, V: int, T: int, counters: str, device):
    """Inputs of the dual biquad: rows cycle through lowpass, highpass and
    bandpass filters at random gains (down to 0.05, the near-DC shelves)
    and unfiltered rows (identity coefficients, as the table holds them);
    the current coefficients are an earlier setting, the targets a new one,
    and the counters all 0 (on target), all 256 (a fresh change) or
    ``"mixed"`` (0, 256 and the steps between).  State z as a running
    filter leaves it; unit-scale x."""
    import torch

    cur = np.zeros((V, 2, 5), np.float32)
    tgt = np.zeros((V, 2, 5), np.float32)
    for v in range(V):
        kind = v % 4
        for out in (cur, tgt):
            g = rng.uniform(0.05, 0.9, 2)
            out[v] = filter_coeffs(g[0] if kind in (0, 2) else 1.0,
                                   g[1] if kind in (1, 2) else 1.0)
        if kind == 3:
            cur[v] = tgt[v] = 0.0
            cur[v, :, 0] = tgt[v, :, 0] = 1.0
    if counters == "mixed":
        cnt = rng.choice(np.arange(0, 257, 32), V)
    else:
        cnt = np.full(V, int(counters))
    cur[cnt == 0] = tgt[cnt == 0]
    T_ = lambda a, dt=torch.float32: torch.tensor(np.asarray(a),  # noqa: E731
                                                  device=device).to(dt)
    return (T_(rng.standard_normal((V, T)) * 0.5),
            T_(rng.standard_normal((V, 2, 2)) * 0.05), T_(cur), T_(tgt),
            T_(cnt, torch.int32))


def span_case(rng, V: int, W: int, taps: int, inc_range: tuple, device):
    """gen_case's voices at increments drawn from ``inc_range`` (16.16,
    inclusive), with every eighth voice moved to the pool's end: its
    buffer runs past the last frame, so its window is staged through the
    address clamp."""
    import torch

    args = list(gen_case(rng, V, W, taps, 1 << 16, device))
    P = args[0].numel()
    off = args[1].cpu().numpy()
    lens = args[2].cpu().numpy()
    tail = np.arange(V) % 8 == 7
    off[tail] = P - rng.integers(1, W + 64, tail.sum())
    lens[tail] = np.maximum(lens[tail], P - off[tail] + 2 * W)
    Ti = lambda a: torch.tensor(np.asarray(a), device=device).to(torch.int32)
    args[1], args[2] = Ti(off), Ti(lens)
    args[9] = Ti(rng.integers(inc_range[0], inc_range[1] + 1, V))
    return tuple(args)


def short_loop_case(rng, V: int, W: int, taps: int, inc_range: tuple,
                    device):
    """span_case's voices, every one looping over 1-3 frames (empty
    sources stay silent), every other one wrapped (its history wraps
    backward), starting from a few taps before loop_start to past
    loop_end, at increments drawn from ``inc_range``."""
    import torch

    args = list(span_case(rng, V, W, taps, inc_range, device))
    lens = args[2].cpu().numpy()
    ls = rng.integers(0, np.maximum(lens - 3, 1))
    le = ls + rng.integers(1, 4, V)
    Ti = lambda a: torch.tensor(np.asarray(a), device=device).to(torch.int32)
    args[3], args[4] = Ti(ls), Ti(le)
    args[5] = torch.ones(V, dtype=torch.bool, device=device)
    args[6] = torch.tensor(np.arange(V) % 2 == 0, device=device)
    args[7] = Ti(ls + rng.integers(-taps - 4, 8, V))
    return tuple(args)


# Phases 7 and 16, for both staged-window kernels (K3, K4): (V, W, taps,
# (lowest, highest increment), kind): ragged widths, the largest window
# with the largest weight tables (taps 48 at 10x), loops of 1-3 frames.
ONE = 1 << 16
WINDOW_CASES = (
    [(256, W, taps, (ONE // 4, 10 * ONE), "branches")
     for W in (1, 100, 1023, 16385) for taps in (4, 48)]
    + [(256, W, 48, (10 * ONE, 10 * ONE), "branches") for W in (1024, 16384)]
    + [(256, W, taps, (ONE // 4, 10 * ONE), "short_loops")
       for W in (128, 1024, 16385) for taps in (1, 4, 48)])


# Phase 3's cases for K1 beyond unit_case, as (W, taps, kind): ragged
# widths with span_case's voices (unit_case's branches and buffers at the
# pool's end), and loops of 1-3 frames, at taps 1, 4 and 48.
UNIT_CASES = (
    [(W, taps, "branches") for W in (1, 100, 1023, 16385)
     for taps in (1, 4, 48)]
    + [(W, taps, "short_loops") for W in (128, 1024, 16385)
       for taps in (1, 4, 48)])

# Phase 17's cases for K5 beyond its first ones: WINDOW_CASES's shapes
# within K5's largest bucket (((max_inc * W) >> 16) + 64 <= 11264).
VOICE_CASES = (
    [(256, W, taps, (ONE // 4, 10 * ONE), "branches")
     for W in (1, 100, 1023) for taps in (4, 48)]
    + [(256, 1024, 48, (10 * ONE, 10 * ONE), "branches")]
    + [(256, 16385, taps, (ONE // 4, 42000), "branches") for taps in (4, 48)]
    + [(256, W, taps, (ONE // 4, 10 * ONE), "short_loops")
       for W in (128, 1024) for taps in (1, 4, 48)]
    + [(256, 16385, taps, (ONE // 4, 42000), "short_loops")
       for taps in (1, 4, 48)])


def unit_weights(args, taps: int):
    """[V, taps] f32 on the voices' device: each voice's constant weights
    at its phase, resampler row and scale (args as gen_case's), as the
    device computes them for the unit plan."""
    import torch

    from openal_soft_tpu_torch.ops import tables
    from openal_soft_tpu_torch.ops.kernels import resample_unit as rs_unit

    frac, row, sf = (a.cpu().numpy() for a in (args[8], args[10], args[11]))
    w = rs_unit.unit_weights_np(tables.weight_bank(), row, sf, frac, taps)
    return torch.tensor(w, device=args[0].device)


def unit_window_case(rng, V: int, W: int, taps: int, kind: str, device):
    """K1's inputs from span_case's voices (kind "branches") or
    short_loop_case's ("short_loops") at unit increment, with their
    weights from unit_weights."""
    make = short_loop_case if kind == "short_loops" else span_case
    args = make(rng, V, W, taps, (ONE, ONE), device)
    return (*args[:8], unit_weights(args, taps))


def check_resample_kernel(cuda, name: str, wrapper, ref, cases,
                          seed: int = 8) -> float:
    """Phases 7 and 16-17: ``wrapper`` bit-equal to its plain version
    ``ref`` over ``cases`` of (V, W, taps, (lowest, highest increment)[,
    kind]): kind "branches" (span_case, the default) or "short_loops"
    (short_loop_case)."""
    import torch

    rng = np.random.default_rng(seed)
    max_err = 0.0
    for V, W, taps, inc_range, *rest in cases:
        kind = rest[0] if rest else "branches"
        make = short_loop_case if kind == "short_loops" else span_case
        args = make(rng, V, W, taps, inc_range, cuda)
        got = wrapper(*args, W, taps)
        want = ref(*args, W, taps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = bool(torch.equal(got, want))
        emit({"phase": "kernel", "name": name, "V": V, "W": W, "taps": taps,
              "inc_range": list(inc_range), "kind": kind,
              "max_abs_err": err, "bit_equal": equal})
        if not equal:
            raise AssertionError(f"{name} != plain at W={W} taps={taps} "
                                 f"inc {inc_range} ({kind}): max |diff| "
                                 f"{err}")
        max_err = max(max_err, err)
        del args, got, want
    return max_err


def launch_fns(name: str, bind, new_fn, parent_extra, args: tuple,
               out) -> dict:
    """{"new": fn, "parent": fn}: one launch each of the kernel ``name``
    (the C entry point ``new_fn``) and, where the build directory holds
    its previous source (``parent_kernel``), of the previous kernel with
    its own trailing arguments ``parent_extra`` instead of the new
    kernel's, each with the ctypes signature ``bind`` gives it and the
    pointer arguments ``args`` (the new kernel's extra arguments last),
    returning ``out``, so that CUDA events time the kernel alone."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, call_args):
        def go():   # holds the tensors whose pointers it passes
            err = fn(*call_args, stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")
            return out
        return go

    n_extra = len(parent_extra)
    fns = {"new": run(new_fn, args)}
    lib = parent_kernel(name)
    if lib is not None:
        old = bind(getattr(lib, f"{name}_launch"))
        fns["parent"] = run(old, (*args[:len(args) - n_extra],
                                  *parent_extra))
    return fns


def window_launchers(name: str, args, W: int, taps: int, bank_sl,
                     max_inc: int) -> dict:
    """launch_fns for the staged-window kernel ``name`` (resample_gen,
    resample_span or resample_voice) as the device calls it (window sized
    for ``max_inc``) on inputs packed once and into one output; the
    previous resample_voice takes its window bucket (span_for_increment)
    where the others take the window's frames."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen
    from openal_soft_tpu_torch.ops.kernels import resample_span as rs_span
    from openal_soft_tpu_torch.ops.kernels import resample_voice as rs_voice

    pool, sf = args[0], args[11]
    meta = rs_gen.pack_meta(*args[1:11])
    V = meta.shape[0]
    out = torch.empty((V, W), dtype=torch.float32, device=pool.device)
    mod = {"resample_gen": rs_gen, "resample_span": rs_span,
           "resample_voice": rs_voice}[name]
    cap = rs_gen.window_cap(max_inc, taps)
    parent = (rs_voice.span_for_increment(max_inc, W)
              if name == "resample_voice" else cap)
    return launch_fns(name, rs_gen.bind_window_launch, mod._launcher(),
                      (parent,),
                      (pool.data_ptr(), pool.numel(), meta.data_ptr(),
                       sf.data_ptr(), bank_sl.data_ptr(), out.data_ptr(), V,
                       W, taps, cap), out)


def unit_launchers(args, W: int) -> dict:
    """launch_fns for the unit kernel (K1) on ``args`` (unit_case's),
    packed once and into one output; the previous kernel takes the same
    arguments."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import resample_unit as rs_unit

    pool, w = args[0], args[8]
    meta = rs_unit.pack_meta(*args[1:8])
    V, taps = w.shape
    out = torch.empty((V, W), dtype=torch.float32, device=pool.device)
    return launch_fns("resample_unit", rs_unit.bind_unit_launch,
                      rs_unit._launcher(), (),
                      (pool.data_ptr(), pool.numel(), meta.data_ptr(),
                       w.data_ptr(), out.data_ptr(), V, W, taps), out)


def time_alone(name: str, fns: dict, want, what: str) -> dict:
    """Phases 4, 9 and 18: the kernel and its previous version (where
    built) each bit-equal to ``want``, then CUDA-event ms per launch over
    20 launches each, in the order previous, new, new, previous."""
    import torch

    for which, fn in fns.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} ({which}) != plain at {what}")
    times = {}
    for key, which in (("parent_ms", "parent"), ("ms", "new"),
                       ("ms_2", "new"), ("parent_ms_2", "parent")):
        if which in fns:
            times[key] = cuda_ms(fns[which], 20, 3)
    return times


def time_window_kernel(name: str, args, W: int, taps: int, bank_sl,
                       max_inc: int, want) -> dict:
    """time_alone for a staged-window kernel as the device calls it."""
    return time_alone(name, window_launchers(name, args, W, taps, bank_sl,
                                             max_inc), want,
                      f"[{W}], taps {taps}")


def rates(row: dict, times: dict, out_bytes: int, bound_ms: float) -> dict:
    """``row`` with ``times`` (ms) and beside each its share of the bound
    and the rate (GB/s) at which it writes the call's ``out_bytes``."""
    return {**row, **times, "bound_share": {
        k: bound_ms / v for k, v in times.items()}, "write_GBps": {
        k: out_bytes / (v * 1e-3) / 1e9 for k, v in times.items()}}


def window_bound(V: int, W: int, taps: int, frac: np.ndarray,
                 inc: np.ndarray, bank_floats: int) -> tuple[float, str]:
    """A windowed resampler call (K4, K5): each voice's source window read
    once (the frames from its first output's first tap to its last
    output's last tap), the output written once, the scalars and the bank
    slice read once; against ~8 flops per tap."""
    frac = frac.astype(np.int64)
    last = (frac + (W - 1) * inc.astype(np.int64)) >> 16
    frames = int(np.sum(last - (frac >> 16) + taps))
    return bound(4 * (frames + V * W + V * 12 + bank_floats),
                 8 * taps * V * W)


def uhj_pool_scene(device: str, n_voices: int, n_bufs: int, frames: int,
                   n_beds: int, n_stems: int, bed_frames: int,
                   conf: str = "stereo-encoding = uhj\n",
                   formats: tuple = ("uhj2", "superstereo")):
    """The uhj_big_pool scene (phase 19) and its small relatives (phase
    20): ``n_voices`` looping mono voices at pitch 2**U(-1,1) over
    ``n_bufs`` distinct seeded tones of ``frames`` frames (positions as
    bench_scene: seed 42, x3.0), ``n_beds`` looping ambience beds in the
    first of ``formats`` and ``n_stems`` in the second (``bed_frames``
    frames each, pitch 1; Super Stereo at its default width 0.46), on a
    stereo device configured by ``conf``; capacity rounded up to a
    multiple of 128 rows.  Returns (device, pool bytes in use)."""
    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    rows = {"uhj2": 3, "uhj3": 3, "uhj4": 4, "superstereo": 3}
    need = n_voices + n_beds * rows[formats[0]] + n_stems * rows[formats[1]]
    with alsoft_conf(conf):
        dev = LoopbackDevice(frequency=RATE, channels="stereo",
                             sample_type="float32",
                             capacity=-(-need // 128) * 128, hrtf=False,
                             device=device)
    ctx = dev.create_context()
    rng = np.random.default_rng(42)
    t = np.arange(frames, dtype=np.float64) / RATE
    bufs = []
    for i in range(n_bufs):
        buf = ctx.create_buffer()
        f0 = 55.0 * 2.0 ** (i / 96.0)
        buf.set_data((0.1 * np.sin(2 * np.pi * f0 * t + i)).astype(
            np.float32), "mono", "float32", RATE)
        bufs.append(buf)
    for i in range(n_voices):
        src = ctx.create_source()
        src.buffer(bufs[i % n_bufs])
        src.looping = True
        src.set("position", tuple(rng.standard_normal(3) * 3.0))
        src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
        src.play()
    tb = np.arange(bed_frames, dtype=np.float64) / RATE
    for k in range(n_beds + n_stems):
        fmt = formats[0] if k < n_beds else formats[1]
        n_ch = 4 if fmt == "uhj4" else 3 if fmt == "uhj3" else 2
        data = np.stack([(0.1 / (c + 1)) * np.sin(
            2 * np.pi * 110.0 * (k + 2) * (c + 1) * tb + c)
            for c in range(n_ch)], axis=1).astype(np.float32)
        buf = ctx.create_buffer()
        buf.set_data(data, fmt, "float32", RATE)
        src = ctx.create_source()
        src.buffer(buf)
        src.looping = True
        src.play()
    return dev, 4 * (dev.pool._top - 8)


# Phase 20: (name, uhj_pool_scene keyword arguments).
UHJ_PARITY = {
    "uhj_pool98": {"n_bufs": 64, "frames": 384000, "n_beds": 2,
                   "n_stems": 2, "bed_frames": 96000},
    "tsme_ss": {"n_bufs": 16, "frames": 48000, "n_beds": 2, "n_stems": 4,
                "bed_frames": 48000, "conf": "stereo-encoding = tsme\n",
                "formats": ("superstereo", "superstereo")},
    "uhj34_fir256_dec": {"n_bufs": 16, "frames": 48000, "n_beds": 2,
                         "n_stems": 2, "bed_frames": 48000,
                         "conf": "stereo-encoding = uhj\n[uhj]\n"
                                 "decode-filter = fir256\n"
                                 "encode-filter = fir512\n",
                         "formats": ("uhj3", "uhj4")},
    "uhj2_ss_fir512_dec": {"n_bufs": 16, "frames": 48000, "n_beds": 2,
                           "n_stems": 2, "bed_frames": 48000,
                           "conf": "stereo-encoding = uhj\n[uhj]\n"
                                   "decode-filter = fir512\n"
                                   "encode-filter = fir256\n"},
}


def pool_voices(rng, V: int, n_bufs: int, frames: int, pitch: tuple, device,
                pool=None):
    """Resampler inputs for timing: V voices looping over n_bufs distinct
    buffers of ``frames`` frames each (a pool of n_bufs * frames seeded
    floats unless ``pool`` is given), at random positions and phases and
    pitch 2**U(pitch), with the global weight bank."""
    import torch

    from openal_soft_tpu_torch.ops import tables

    if pool is None:
        gen = torch.Generator(device=device).manual_seed(5)
        pool = 0.1 * torch.randn(8 + n_bufs * frames + 4096, device=device,
                                 generator=gen)
    Ti = lambda a: torch.tensor(np.asarray(a), device=device).to(torch.int32)
    lens = np.full(V, frames)
    bank = {k: torch.tensor(v, device=device)
            for k, v in tables.weight_bank().items()}
    return (pool, Ti(8 + (np.arange(V) % n_bufs) * frames), Ti(lens),
            Ti(np.zeros(V)), Ti(lens),
            torch.ones(V, dtype=torch.bool, device=device),
            torch.tensor(rng.random(V) < 0.5, device=device),
            Ti(rng.integers(0, frames, V)),
            Ti(rng.integers(0, 1 << 16, V)),
            Ti(np.floor(2.0 ** rng.uniform(*pitch, V) * 65536)),
            Ti(np.zeros(V)),
            torch.tensor(rng.random(V).astype(np.float32), device=device),
            bank)


def phase_timings(cuda, report: dict, smi: str) -> None:
    """Phase 18: the span (K4), general (K3) and per-voice (K5) resamplers
    on the same inputs, each kernel alone (beside its previous version
    where the build directory holds it) and through its wrapper, each
    held bit-equal to the plain version first.  [4096, 16512]
    (uhj_big_pool's 16-block window with the UHJ look-ahead) on a 268 MB
    pool at pitch 2**U(-1,1), K4 and K3; at pitch 2**U(-1,-0.6), where
    K5's largest bucket covers 16512 outputs, all three; K5 at the TPU
    kernel's [4096, 1024] at that pitch; and K4 and K3 at the loaded
    scene's [4096, 16384] on its 9.2 MB pool of 48 one-second tones."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen
    from openal_soft_tpu_torch.ops.kernels import resample_span as rs_span
    from openal_soft_tpu_torch.ops.kernels import resample_voice as rs_voice

    taps = 4
    fns = {"resample_span": rs_span.resample_span,
           "resample_gen": rs_gen.resample_gen,
           "resample_voice": rs_voice.resample_voice}
    rng = np.random.default_rng(11)
    big = None
    tones = torch.tensor(np.concatenate(
        [np.zeros(8, np.float32), *tone_pool(N_TONES),
         np.zeros(4096, np.float32)]), device=cuda)
    cases = (("pool268MB", 16 * BLOCK + 128, (-1.0, 1.0),
              ("resample_span", "resample_gen")),
             ("pool268MB", 16 * BLOCK + 128, (-1.0, -0.6),
              ("resample_span", "resample_gen", "resample_voice")),
             ("pool268MB", BLOCK, (-1.0, -0.6), ("resample_voice",)),
             ("pool9MB", 16 * BLOCK, (-1.0, 1.0),
              ("resample_span", "resample_gen")))
    for pool_name, W, pitch, names in cases:
        if pool_name == "pool268MB":
            args = pool_voices(rng, N_VOICES, 1024, 65536, pitch, cuda,
                               pool=big)
            big = args[0]
        else:
            args = pool_voices(rng, N_VOICES, N_TONES, RATE, pitch, cuda,
                               pool=tones)
        sl = rs_gen.slice_bank(args[-1], taps)
        want = rs_gen.resample_gen_ref(*args, W, taps)
        plain_ms = cuda_ms(lambda: rs_gen.resample_gen_ref(*args, W, taps),
                           3, 1)
        frac, inc = args[8].cpu().numpy(), args[9].cpu().numpy()
        row = {"phase": "timing", "pool": pool_name,
               "pool_bytes": 4 * args[0].numel(), "V": N_VOICES, "W": W,
               "taps": taps, "pitch": list(pitch), "plain_ms": plain_ms,
               "nvidia_smi": smi}
        max_inc = int(inc.max())
        for name in names:
            times = time_window_kernel(name, args, W, taps, sl, max_inc,
                                       want)
            times["wrapper_ms"] = cuda_ms(lambda: fns[name](
                *args, W, taps, bank_sl=sl, max_inc=max_inc), 20, 3)
            if name == "resample_gen":
                bound_ms, bound_by = resample_bound(
                    N_VOICES, W, taps, args[0].numel(), 12, sl.numel())
            else:
                bound_ms, bound_by = window_bound(N_VOICES, W, taps, frac,
                                                  inc, sl.numel())
            row[name] = rates({"bound_ms": bound_ms, "bound_by": bound_by},
                              times, 4 * N_VOICES * W, bound_ms)
            main = {"resample_span": pitch == (-1.0, 1.0)
                    and pool_name == "pool268MB",
                    "resample_voice": W == 16 * BLOCK + 128}.get(name, False)
            if main:
                report[name].update(ms=times["ms"], plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
        emit(row)
        del args, want


def phase_uhj_big_pool(wrappers: dict, report: dict, smi: str) -> None:
    """Phase 19: uhj_big_pool at full width through the port's entry
    points, one warm and one timed 512-block call."""
    import torch

    frames = CHUNK_BLOCKS * BLOCK
    t0 = time.perf_counter()
    dev, pool_bytes = uhj_pool_scene("cuda", N_VOICES, 1024, 4 * RATE, 16, 8,
                                     20 * RATE)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev.render_samples(frames)                       # warm
    warm_s = time.perf_counter() - t0
    plan = dev._rs_plan(BLOCK, CHUNK_BLOCKS)
    for name in KERNELS:
        wrappers[name].launches = 0
    t0 = time.perf_counter()
    out = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in KERNELS}
    for name in ("resample_span", "resample_voice"):
        report[name]["launches"] = launches[name]   # K5: on no path
    finite = bool(np.isfinite(out).all())
    peak = float(np.abs(out).max())
    emit({"phase": "uhj_big_pool", "voices": N_VOICES, "rows": dev.capacity,
          "frames": frames, "pool_bytes": pool_bytes,
          "pool_extent_bytes": dev._pool_extent_bytes,
          "l2_bytes": dev.l2_bytes, "plan": list(plan),
          "uhj_pad": dev._uhj_pad(), "setup_s": setup_s, "warm_s": warm_s,
          "render_s": dt, "x_realtime": (frames / RATE) / dt,
          "launches": launches, "finite": finite, "peak": peak,
          "shape": list(out.shape), "nvidia_smi": smi})
    if out.shape != (frames, 2) or not finite or not peak > 0.0:
        raise AssertionError("uhj_big_pool output is not finite, nonzero "
                             f"[{frames}, 2]: shape {out.shape}, "
                             f"finite {finite}, peak {peak}")
    if not (launches["resample_span"] > 0 and launches["resample_gen"] == 0
            and launches["biquad"] > 0 and pool_bytes >= 900e6):
        raise AssertionError(f"uhj_big_pool: pool {pool_bytes} bytes, "
                             f"launches {launches}")


def phase_uhj_parity(wrappers: dict) -> None:
    """Phase 20: the UHJ scenes at 64 voices on the card against the
    port on the CPU."""
    for name, kw in UHJ_PARITY.items():
        g, _ = uhj_pool_scene("cuda", 64, **kw)
        c, pool_bytes = uhj_pool_scene("cpu", 64, **kw)
        before = {k: wrappers[k].launches for k in KERNELS}
        for n, path in ((8192, "multi-block"), (4096, "per-block"),
                        (100, "odd"), (924, "odd")):
            a, b = g.render_samples(n), c.render_samples(n)
            err = float(np.abs(a - b).max())
            emit({"phase": "parity", "scene": name, "frames": n,
                  "path": path, "pool_bytes": pool_bytes,
                  "plan": list(g._rs_plan(BLOCK, 8)),
                  "max_abs_err": err, "tol": UHJ_TOL,
                  "peak": float(np.abs(b).max())})
            if not (np.isfinite(a).all() and err <= UHJ_TOL
                    and np.abs(b).max() > 1e-3):
                raise AssertionError(f"{name} GPU vs CPU port at {n} "
                                     f"frames: {err}")
        grew = {k: wrappers[k].launches - before[k] for k in KERNELS}
        need = ["resample_span" if name == "uhj_pool98" else "resample_gen"]
        if "fir" not in name:             # the IIR tier's all-passes
            need.append("biquad")
        if not all(grew[k] > 0 for k in need):
            raise AssertionError(f"{name} skipped a kernel: {grew}")



def cuda_ms(fn, iters: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int, warmup: int) -> float:
    """Device time of one call of fn: the CUDA kernels' own time summed by
    torch.profiler over ``iters`` calls, so that the host's launch cost of a
    kernel shorter than it does not count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dtime = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    for _ in range(3):   # a session may record no kernel: take another
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]
                                    ) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = sum(dtime(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / iters
        if ms > 0.0:
            return ms
    raise RuntimeError("torch.profiler recorded no device time in three "
                       "sessions")


def parent_kernel(name: str):
    """The previous version of csrc/<name>.cu, where a copy of it stands
    in the build directory's ``parent/`` (written there with ``git show
    <commit>:openal_soft_tpu_torch/csrc/<name>.cu``, beside the previous
    version of any header it includes, or the current csrc/ one is used),
    built with the same flags and loaded; None without one."""
    import ctypes

    from openal_soft_tpu_torch.ops.kernels import _build

    src = _build.BUILD_DIR / "parent" / f"{name}.cu"
    if not src.exists():
        return None
    return ctypes.CDLL(str(_build.build(f"parent_{name}", src)))


def ptxas_lines(name: str) -> list[str]:
    from openal_soft_tpu_torch.ops.kernels import _build

    return [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln
            or "Function properties" in ln]


def build_all() -> None:
    """Phase 2: one nvcc per source, all started together, beside g++ and
    gcc building the C ABI (libopenal_torch.so and its two C clients) and
    the output limiter for phase 32."""
    from openal_soft_tpu_torch.native import build as native
    from openal_soft_tpu_torch.ops.kernels import _build

    def native_all() -> dict:
        t0 = time.perf_counter()
        libs = {"limiter": native.build_limiter(),
                **{c: native.build_client(c) for c in native.CLIENTS}}
        NATIVE_BUILD["seconds"] = time.perf_counter() - t0
        return libs

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        c_abi = pool.submit(native_all)
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
        seconds = time.perf_counter() - t0
        NATIVE_BUILD["files"] = {k: str(v) for k, v in c_abi.result().items()}
    for name in KERNELS:
        _build.load_library(name)
        emit({"phase": "build", "kernel": name, "library": libs[name].name,
              "seconds": seconds, "ptxas": ptxas_lines(name)})
    emit({"phase": "build", "c_abi": NATIVE_BUILD["files"],
          "seconds": NATIVE_BUILD["seconds"]})


# The C ABI's build (phase 2), read by phase 32.
NATIVE_BUILD: dict = {}


def check_unit_kernel(cuda) -> float:
    """Phase 3: resample_unit bit-equal to its plain version on unit_case's
    voices (random weights), then over UNIT_CASES (the bank's weights)."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import resample_unit as rs_unit

    rng = np.random.default_rng(0)
    cases = ([(W, taps, "unit_case") for taps in (4, 24, 48)
              for W in (128, 1024, 16384)] + list(UNIT_CASES))
    max_err = 0.0
    for W, taps, kind in cases:
        if kind == "unit_case":
            args = unit_case(rng, 256, W, taps, cuda)
        else:
            args = unit_window_case(rng, 256, W, taps, kind, cuda)
        got = rs_unit.resample_unit(*args, W)
        want = rs_unit.resample_unit_ref(*args, W)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = bool(torch.equal(got, want))
        emit({"phase": "kernel", "name": "resample_unit", "V": 256, "W": W,
              "taps": taps, "kind": kind, "max_abs_err": err,
              "bit_equal": equal})
        if not equal:
            raise AssertionError(f"resample_unit != plain at W={W} "
                                 f"taps={taps} ({kind}): max |diff| {err}")
        max_err = max(max_err, err)
    return max_err


def phase_unit_timings(cuda, report: dict, smi: str, pool: np.ndarray
                       ) -> None:
    """Phase 4: resample_unit at [4096, 16384] and [4096, 1024], taps 4, on
    best_case's 48 looping tones, each voice's weights at a random phase
    and resampler row: the kernel alone beside the previous kernel (where
    the build directory holds parent/resample_unit.cu), through its
    wrapper, and its plain version; at 16384 also resample_gen (K3) on the
    same voices at increment 1<<16, which computes the same function."""
    import torch

    from openal_soft_tpu_torch.ops import tables
    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen
    from openal_soft_tpu_torch.ops.kernels import resample_unit as rs_unit

    V, taps = N_VOICES, 4
    rng = np.random.default_rng(4)
    Ti = lambda a: torch.tensor(np.asarray(a), device=cuda).to(torch.int32)
    lens = np.full(V, RATE)
    bank = {k: torch.tensor(v, device=cuda)
            for k, v in tables.weight_bank().items()}
    gargs = (torch.tensor(pool, device=cuda),
             Ti(8 + (np.arange(V) % N_TONES) * RATE), Ti(lens),
             Ti(np.zeros(V)), Ti(lens),
             torch.ones(V, dtype=torch.bool, device=cuda),
             torch.tensor(rng.random(V) < 0.5, device=cuda),
             Ti(rng.integers(0, RATE, V)), Ti(rng.integers(0, 1 << 16, V)),
             Ti(np.full(V, ONE)), Ti(rng.integers(0, 52, V)),
             torch.tensor(rng.random(V).astype(np.float32), device=cuda),
             bank)
    args = (*gargs[:8], unit_weights(gargs, taps))
    for W in (16 * BLOCK, BLOCK):
        want = rs_unit.resample_unit_ref(*args, W)
        got = rs_unit.resample_unit(*args, W)
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            raise AssertionError(f"resample_unit != plain at [{V}, {W}]: "
                                 f"max |diff| {err}")
        del got
        times = time_alone("resample_unit", unit_launchers(args, W), want,
                           f"[{V}, {W}]")
        times["wrapper_ms"] = cuda_ms(
            lambda: rs_unit.resample_unit(*args, W), 20, 3)
        plain_ms = cuda_ms(lambda: rs_unit.resample_unit_ref(*args, W), 5, 1)
        bound_ms, bound_by = resample_bound(V, W, taps, pool.size, 8,
                                            V * taps)
        row = {"phase": "timing", "name": "resample_unit", "V": V, "W": W,
               "taps": taps, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "nvidia_smi": smi}
        if W == 16 * BLOCK:
            report["resample_unit"].update(ms=times["ms"], plain_ms=plain_ms,
                                           bound_ms=bound_ms,
                                           bound_by=bound_by)
            sl = rs_gen.slice_bank(bank, taps)
            k3 = time_window_kernel("resample_gen", gargs, W, taps, sl, ONE,
                                    want)
            row["resample_gen"] = rates({}, k3, 4 * V * W, bound_ms)
        emit(rates(row, times, 4 * V * W, bound_ms))
        del want


def check_gen_kernel(cuda) -> float:
    """Phase 7: resample_gen bit-equal to its plain version, then over
    WINDOW_CASES."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen

    rng = np.random.default_rng(1)
    max_err = 0.0
    for taps in (1, 2, 4, 24, 48):
        for W, max_inc in ((128, 10 << 16), (1024, 10 << 16),
                           (16384, 1 << 17)):
            args = gen_case(rng, 256, W, taps, max_inc, cuda)
            got = rs_gen.resample_gen(*args, W, taps)
            want = rs_gen.resample_gen_ref(*args, W, taps)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            equal = bool(torch.equal(got, want))
            emit({"phase": "kernel", "name": "resample_gen", "V": 256,
                  "W": W, "taps": taps, "max_inc": max_inc,
                  "max_abs_err": err, "bit_equal": equal})
            if not equal:
                raise AssertionError(f"resample_gen != plain at W={W} "
                                     f"taps={taps}: max |diff| {err}")
            max_err = max(max_err, err)
    return max(max_err, check_resample_kernel(
        cuda, "resample_gen", rs_gen.resample_gen, rs_gen.resample_gen_ref,
        WINDOW_CASES, seed=12))


def reverb_case(rate: int, crossfade: bool, device: str, **props):
    """A device with one EAXReverb slot: (effect, device params, slot
    state).  Modulation is on so every stage runs, ``props`` on top; with
    ``crossfade`` a second full update leaves the old pipeline "B"
    fading."""
    import torch

    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    dev = LoopbackDevice(frequency=rate, hrtf=True, capacity=4,
                         device=device)
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("eaxreverb"))
    slot.set_props(modulation_depth=0.6, modulation_time=0.3, **props)
    params = slot.compute_update()
    if crossfade:
        slot.set_props(decay_time=2.7, density=0.4, diffusion=0.7,
                       reflections_delay=0.05, late_reverb_delay=0.02)
        params = slot.compute_update()
    eff = slot.state
    prm = {k: torch.tensor(params[k], device=dev.torch_device)
           for k in eff.device_params if k in params}
    return eff, prm, dev._state["slot0"]


def run_reverb_windows(eff, prm, state, windows, mode: str,
                       parent=None) -> list:
    """Feed ``windows`` ([4, T] tensors) through every live pipeline;
    returns the outputs.  ``mode``: "kernel" (the wrapper, with the
    effect's late-tap bound: chunk k+1's early half beside chunk k's late
    half where that is legal), "in_order" (the wrapper without it),
    "plain" (the plain version) or "parent" (the ``parent`` library, the
    previous kernel, through its own C interface)."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import reverb as rev_k

    ctab = eff._tables(state["main"].device)["ctab"]
    pipes = [("A", "")] + ([("B", "old_")] if eff._old_active else [])
    outs = []
    for ain in windows:
        for n, (name, prefix) in enumerate(pipes):
            st = state[name]
            args = (ain, state["main"], st, prm[prefix + "pi"],
                    prm[prefix + "pf"], state["offset"], ctab)
            kw = dict(write_main=n == 0, chunk=eff.chunk,
                      e_passes=eff.early_ap_passes,
                      l_passes=eff.late_ap_passes, mod_win=eff.mod_win)
            if mode == "plain":
                outs += rev_k.reverb_pipeline_ref(*args, **kw)
            elif mode == "parent":
                early, late = torch.empty_like(ain), torch.empty_like(ain)
                c = [ain.data_ptr(), ain.shape[1], int(n == 0),
                     state["offset"].data_ptr(), state["main"].data_ptr(),
                     state["main"].shape[1]]
                for k in rev_k.RINGS:
                    c += [st[k].data_ptr(), st[k].shape[1]]
                c += [st[k].data_ptr() for k in rev_k.ZSTATES]
                c += [st["mod_index"].data_ptr(), st["serial_done"].data_ptr(),
                      prm[prefix + "pi"].data_ptr(),
                      prm[prefix + "pf"].data_ptr(), ctab.data_ptr(),
                      early.data_ptr(), late.data_ptr(), eff.chunk,
                      eff.early_ap_passes, eff.late_ap_passes, eff.mod_win,
                      torch.cuda.current_stream().cuda_stream]
                if parent.reverb_pipeline_launch(*c) != 0:
                    raise RuntimeError("parent reverb kernel failed")
                outs += [early, late]
            else:
                tap = eff._late_tap_max[prefix] if mode == "kernel" else None
                outs += rev_k.reverb_pipeline(*args, **kw, max_late_tap=tap)
        state["offset"].add_(ain.shape[1])
    return outs


def bind_parent_reverb(lib):
    """ctypes signature of the previous reverb kernel's C entry point."""
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.reverb_pipeline_launch
    fn.argtypes = ([P, I, I, P, P, I] + [P, I] * 5 + [P] * 4 + [P] * 7
                   + [I, I, I, I, P])
    fn.restype = I
    return lib


def reverb_windows(rng, T: int, chunk: int, device, min_chunks: int = 128):
    """Windows [4, T] covering >= min_chunks chunks: input in the first
    half, silence after (the decaying tail)."""
    import torch

    n = max(2, -(-min_chunks * chunk // T))
    return [torch.tensor((rng.standard_normal((4, T)) * 0.25).astype(
        np.float32) if k < n // 2 else np.zeros((4, T), np.float32),
        device=device) for k in range(n)]


def check_reverb_kernel(cuda) -> float:
    """Phase 8: the reverb kernel against its plain version, outputs and
    carried state, bit-equal and within REVERB_TOL: at 44.1, 48 and 96 kHz,
    one pipeline and the A/B crossfade, windows of 1024 and 16384, >= 128
    chunks each including the decaying tail, with chunk k+1's early half
    beside chunk k's late half; then the in-order schedule the wrapper
    takes without a late-tap bound, and density 0 and 1 with
    late_reverb_delay 0 and its maximum 0.1 s (>= 64 chunks)."""
    import torch

    rng = np.random.default_rng(2)
    cases = [(rate, crossfade, T, "kernel", {}, 128)
             for rate in (44100, 48000, 96000) for crossfade in (False, True)
             for T in (1024, 16384)]
    cases += [(rate, True, 1024, "in_order", {}, 128)
              for rate in (44100, 48000, 96000)]
    cases += [(rate, False, 1024, "kernel",
               {"density": density, "late_reverb_delay": delay}, 64)
              for rate in (48000, 96000) for density in (0.0, 1.0)
              for delay in (0.0, 0.1)]
    max_err = 0.0
    for rate, crossfade, T, mode, props, chunks in cases:
        eff, prm, st = reverb_case(rate, crossfade, "cuda", **props)
        st_plain = copy.deepcopy(st)
        windows = reverb_windows(rng, T, eff.chunk, cuda, min_chunks=chunks)
        got = run_reverb_windows(eff, prm, st, windows, mode)
        want = run_reverb_windows(eff, prm, st_plain, windows, "plain")
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        for name in ("A", "B"):
            for k, v in st[name].items():
                err = max(err, float((v.double() - st_plain[name][k]
                                      .double()).abs().max()))
                equal &= torch.equal(v, st_plain[name][k])
        tail = float(max(o.abs().max() for o in got[-2:]))
        emit({"phase": "kernel", "name": "reverb", "rate": rate,
              "crossfade": crossfade, "T": T, "schedule": mode, **props,
              "chunks": len(windows) * T // eff.chunk,
              "late_tap_max": eff._late_tap_max,
              "len_late_in": eff.len_late_in,
              "max_abs_err": err, "tol": REVERB_TOL, "tail_peak": tail,
              "bit_equal": equal})
        if not (err <= REVERB_TOL and equal):
            raise AssertionError(f"reverb != plain at {rate} Hz, T={T}, "
                                 f"crossfade={crossfade}, {mode}, {props}: "
                                 f"{err}")
        max_err = max(max_err, err)
    return max_err


def paths_case(rng, V: int, T: int, P: int, device):
    """x [V, T] and P filter paths laid out as the device holds its aux
    sends (state [V, P, ...], each path a strided view): biquad_case's
    filters and mixed counters per path, active masks ~70 % set, path 1
    without one.  Returns (x, (z, coeffs, target, counter, active))."""
    import torch

    x = biquad_case(rng, V, T, "mixed", device)[0]
    parts = [biquad_case(rng, V, T, "mixed", device)[1:] for _ in range(P)]
    st = tuple(torch.stack([q[i] for q in parts], 1).contiguous()
               for i in range(4))
    return x, st + (torch.tensor(rng.random((V, P)) < 0.7, device=device),)


def as_paths(st) -> list:
    """paths_case's state as biquad_paths' FilterPaths (views)."""
    from openal_soft_tpu_torch.ops.kernels import biquad as biq

    z, cf, tgt, cnt, fa = st
    return [biq.FilterPath(z[:, p], cf[:, p], tgt[:, p], cnt[:, p],
                           None if p == 1 else fa[:, p])
            for p in range(z.shape[1])]


def allpass_case(rng, B: int, T: int, device):
    """A UHJ codec's four-section all-pass cascade over B rows (ops/uhj.py
    _allpass4): sections [a, 0, -1, 0, -a] of the +90 filter's
    coefficients, counter 0, a running state."""
    import torch

    from openal_soft_tpu_torch.ops import uhj

    cf = torch.tensor([[a, 0.0, -1.0, 0.0, -a] for a in uhj.FILTER2_COEFF],
                      dtype=torch.float32, device=device)
    cf = cf.expand(B, 4, 5).contiguous()
    T_ = lambda a: torch.tensor(a.astype(np.float32), device=device)  # noqa
    return (T_(rng.standard_normal((B, T)) * 0.3),
            T_(rng.standard_normal((B, 4, 2)) * 0.1), cf, cf,
            torch.zeros(B, dtype=torch.int32, device=device))


def phase_reverb_timings(cuda, report: dict, smi: str) -> None:
    """Phase 9 (second half): the reverb kernel's device time per window at
    48 kHz, W = 16384 (the loaded scene's super-block) and W = 1024
    (speakers_filtered's per-block launch), beside the previous kernel's
    where the build directory holds its source (previous, new, new,
    previous; torch.profiler's kernel time) and the in-order schedule's."""
    lib = parent_kernel("reverb")
    if lib is not None:
        bind_parent_reverb(lib)
    rng = np.random.default_rng(3)
    for W in (16 * BLOCK, BLOCK):
        eff, prm, st = reverb_case(RATE, False, "cuda")
        ain = reverb_windows(rng, W, eff.chunk, cuda, min_chunks=1)[:1]
        run = lambda mode: (  # noqa: E731
            lambda: run_reverb_windows(eff, prm, st, ain, mode, lib))
        iters = 20 if W > BLOCK else 100
        times = {}
        for key, mode in (("parent_ms", "parent"), ("ms", "kernel"),
                          ("in_order_ms", "in_order"), ("ms_2", "kernel"),
                          ("parent_ms_2", "parent")):
            if mode != "parent" or lib is not None:
                times[key] = device_ms(run(mode), iters, 3)
        bound_ms, bound_by = reverb_bound(eff, W)
        row = rates({"phase": "timing", "name": "reverb", "W": W,
                     "chunk": eff.chunk, "bound_ms": bound_ms,
                     "bound_by": bound_by, "nvidia_smi": smi}, times,
                    2 * 4 * 4 * W, bound_ms)   # early and late, [4, W]
        row["us_per_chunk"] = {k: 1e3 * v / (W // eff.chunk)
                               for k, v in times.items()}
        if W > BLOCK:
            plain_ms = cuda_ms(run("plain"), 2, 1)
            row["plain_ms"] = plain_ms
            report["reverb"].update(ms=times["ms"], plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
        emit(row)
        del eff, prm, st


def check_biquad_kernel(cuda) -> float:
    """Phase 12: the biquad kernel bit-equal to its plain version, outputs
    and carried state, over two consecutive calls: one two-section path
    (V 100 and 256, T 128, 1024 and 16384, counters 0, 256 and mixed); P =
    1..3 paths over one x with mixed active masks and state in place, at V
    100 and 4097 (not multiples of the 16-line group), T 32, 1024 and
    16384; four-section all-pass cascades at 3, 24 and 48 rows."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import biquad as biq

    rng = np.random.default_rng(4)
    cases = [(V, T, c) for V in (100, 256) for T in (128, 1024)
             for c in ("0", "256", "mixed")]
    cases += [(V, 16384, "mixed") for V in (100, 256)]
    max_err = 0.0

    def record(row, got, want):
        nonlocal max_err
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        emit({"phase": "kernel", "name": "biquad", **row, "calls": 2,
              "max_abs_err": err, "bit_equal": equal})
        if not equal:
            raise AssertionError(f"biquad != plain at {row}: {err}")
        max_err = max(max_err, err)

    for V, T, counters in cases:
        x, z, cf, tgt, cnt = biquad_case(rng, V, T, counters, cuda)
        x2 = torch.tensor((rng.standard_normal((V, T)) * 0.5).astype(
            np.float32), device=cuda)
        got = want = (None, z, cf, cnt)
        for xin in (x, x2):                  # state carried to a 2nd call
            got = biq.biquad_dual(xin, got[1], got[2], tgt, got[3])
            want = biq.biquad_dual_ref(xin, want[1], want[2], tgt, want[3])
        torch.cuda.synchronize()
        record({"V": V, "T": T, "counters": counters, "paths": 1,
                "sections": 2, "lines_mid_interpolation":
                int((got[3] > 0).sum())}, got, want)
    for V, T in ((100, 32), (100, 1024), (100, 16384), (4097, 32),
                 (4097, 1024)):
        for P in (1, 2, 3):
            x, st = paths_case(rng, V, T, P, cuda)
            k_st = tuple(t.clone() for t in st)
            ys_k, ys_p = [], []
            for xin in (x, x.flip(1).contiguous()):
                ys_k.append(biq.biquad_paths(xin, as_paths(k_st)))
                ys_p.append(biq.biquad_paths_ref(xin, as_paths(st)))
            torch.cuda.synchronize()
            record({"V": V, "T": T, "paths": P, "sections": 2,
                    "masked_off": int((~st[4]).sum())},
                   ys_k + list(k_st), ys_p + list(st))
    for B in (3, 24, 48):
        for T in (32, 1024):
            x, z, cf, tgt, cnt = allpass_case(rng, B, T, cuda)
            got = biq.biquad_dual(x, z, cf, tgt, cnt)
            want = biq.biquad_dual_ref(x, z, cf, tgt, cnt)
            torch.cuda.synchronize()
            record({"V": B, "T": T, "paths": 1, "sections": 4}, got, want)
    return max_err


def biquad_bound(V: int, T: int, P: int = 1, S: int = 2
                 ) -> tuple[float, str]:
    """A biquad call over P paths of S sections: x read once, each path's
    y written once, its state, coefficients, targets, counter (and mask)
    read and written once; against 9 flops per section and sample."""
    return bound(4 * (V * T * (1 + P) + P * V * (2 * 2 * S + 3 * 5 * S + 2))
                 + P * V, 9 * S * V * T * P)


def phase_biquad_timings(cuda, report: dict, smi: str) -> None:
    """Phase 13: the biquad kernel's device time (torch.profiler's kernel
    time, CUDA events count the host's launch cost at these sizes) beside
    the previous kernel's, alternating (previous, new, new, previous),
    where the build directory holds the previous source: the device's call
    at V = 4096, T = 1024 (three masked paths: the direct filter and two
    sends, where the previous kernel took three launches and the selects);
    one two-section path at T = 1024 and 16384; the UHJ codecs' four-section
    cascades at 24 and 3 rows (two launches before).  Then the chain's
    floor: one thread's cycles per sample of a section's loop-carried chain
    and the SM clock, from the kernel's probe."""
    import ctypes

    import torch

    from openal_soft_tpu_torch.ops.kernels import biquad as biq

    lib = parent_kernel("biquad")
    if lib is not None:
        lib.biquad_dual_launch.argtypes = ([ctypes.c_void_p] * 9
                                           + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p])
        lib.biquad_dual_launch.restype = ctypes.c_int

    def parent(x, z, cf, tgt, cnt):
        outs = [torch.empty_like(t) for t in (x, z, cf, cnt)]
        err = lib.biquad_dual_launch(
            x.data_ptr(), z.data_ptr(), cf.data_ptr(), tgt.data_ptr(),
            cnt.data_ptr(), *[t.data_ptr() for t in outs], x.shape[0],
            x.shape[1], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent biquad kernel failed: {err}")
        return outs

    cycles, ns = biq.chain_probe(1 << 20, cuda)
    ns_per_sample = ns / (1 << 20)
    emit({"phase": "timing", "name": "biquad_chain", "samples": 1 << 20,
          "cycles_per_sample": cycles / (1 << 20),
          "ns_per_sample": ns_per_sample, "sm_GHz": cycles / ns,
          "nvidia_smi": smi})

    def timed(row, new, old):
        times = {}
        for key, fn in (("parent_ms", old), ("ms", new), ("ms_2", new),
                        ("parent_ms_2", old)):
            if fn is not None:
                times[key] = device_ms(fn, 50, 5)
        row.update(chain_floor_ms=row["T"] * ns_per_sample * 1e-6,
                   nvidia_smi=smi)
        emit(rates({"phase": "timing", "name": "biquad", **row}, times,
                   4 * row["paths"] * row["V"] * row["T"], row["bound_ms"]))
        return times

    rng = np.random.default_rng(6)
    # the device's call: direct + 2 sends, masked, in place
    x, st = paths_case(rng, N_VOICES, BLOCK, 3, cuda)
    fa = st[4]
    paths = as_paths(st)
    if not torch.equal(biq.biquad_paths(x, as_paths(tuple(
            t.clone() for t in st))), biq.biquad_paths_ref(x, as_paths(
                tuple(t.clone() for t in st)))):
        raise AssertionError("biquad != plain at the device's call")

    def parent_paths():
        for p, q in enumerate(paths):
            m = fa[:, p]
            y, z2, cf2, cnt2 = parent(x, q.z.contiguous(),
                                      q.coeffs.contiguous(),
                                      q.target.contiguous(),
                                      q.counter.contiguous())
            q.z.copy_(torch.where(m[:, None, None], z2, 0.0))
            q.coeffs.copy_(torch.where(m[:, None, None], cf2, q.target))
            q.counter.copy_(torch.where(m, cnt2, 0))
            torch.where(m[:, None], y, x)

    row = {"call": "device", "V": N_VOICES, "T": BLOCK, "paths": 3,
           "sections": 2}
    bound_ms, bound_by = biquad_bound(N_VOICES, BLOCK, 3)
    row.update(bound_ms=bound_ms, bound_by=bound_by)
    times = timed(row, lambda: biq.biquad_paths(x, paths),
                  parent_paths if lib is not None else None)
    plain_ms = cuda_ms(lambda: biq.biquad_paths_ref(x, paths), 1, 1)
    report["biquad"].update(ms=times["ms"], plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    del x, st, paths
    for T in (BLOCK, 16 * BLOCK):
        args = biquad_case(rng, N_VOICES, T, "mixed", cuda)
        row = {"call": "one path", "V": N_VOICES, "T": T, "paths": 1,
               "sections": 2}
        row.update(zip(("bound_ms", "bound_by"), biquad_bound(N_VOICES, T)))
        timed(row, lambda: biq.biquad_dual(*args),
              (lambda: parent(*args)) if lib is not None else None)
        del args
    for B in (24, 3):
        x, z, cf, tgt, cnt = allpass_case(rng, B, BLOCK, cuda)
        za, zb = z[:, :2].contiguous(), z[:, 2:].contiguous()
        ca, cb = cf[:, :2].contiguous(), cf[:, 2:].contiguous()
        row = {"call": "uhj allpass4", "V": B, "T": BLOCK, "paths": 1,
               "sections": 4}
        row.update(zip(("bound_ms", "bound_by"),
                       biquad_bound(B, BLOCK, 1, 4)))
        timed(row, lambda: biq.biquad_dual(x, z, cf, tgt, cnt),
              (lambda: parent(parent(x, za, ca, ca, cnt)[0], zb, cb, cb,
                              cnt)) if lib is not None else None)


# --- the effect engines (phases 21-25) ----------------------------------------

# fx_rack's engines and their properties: one slot per engine name in the
# port's registry except null and reverb (the 14 engines of this slice and
# eaxreverb).
FX_PROPS = {
    "autowah": {}, "chorus": {}, "compressor": {}, "convolution": {},
    "dedicated_dialog": {}, "dedicated_lfe": {}, "distortion": {},
    "echo": {"delay": 0.05, "lr_delay": 0.03},
    "equalizer": {"low_gain": 2.0, "mid1_gain": 0.5, "high_gain": 1.5},
    "flanger": {}, "frequency_shifter": {"frequency": 250.0,
                                         "right_direction": 1},
    "pitch_shifter": {"coarse_tune": 7}, "ring_modulator": {},
    "vocal_morpher": {"phoneme_b": 4},
}
FX_ENGINES = tuple(FX_PROPS)
# The engines whose kernels a parity scene must launch.
FX_KERNELS = {"equalizer": "biquad", "distortion": "biquad",
              "ring_modulator": "biquad", "echo": "biquad",
              "compressor": "effect_scan", "autowah": "effect_scan"}


def conv_ir(seed: int) -> np.ndarray:
    """The convolution slot's impulse response: one second of decaying
    noise at 48 kHz, mono, made from the seed."""
    rng = np.random.default_rng(seed + 1)
    t = np.arange(RATE) / RATE
    return (rng.standard_normal(RATE) * np.exp(-t * 6.0) * 0.3).astype(
        np.float32)


def fx_rack_scene(n_voices: int, device: str, seed: int,
                  engines=FX_ENGINES, reverb: bool = True,
                  channels: str = "surround51", hrtf: bool = False):
    """fx_rack: n_voices looping mono voices at pitch 2**U(-1,1) over the
    48 tones, positions x3.0; a slot per engine, send 0 of voice v to
    engine slot v mod len(engines), and with ``reverb`` send 1 of every
    voice to an EAXReverb slot.  48 kHz float32, 2 aux sends."""
    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    dev = LoopbackDevice(frequency=RATE, channels=channels,
                         sample_type="float32", capacity=n_voices,
                         hrtf=hrtf, num_aux_sends=2, device=device)
    ctx = dev.create_context()
    slots = []
    for name in engines:
        slot = ctx.create_aux_slot()
        eff = ctx.create_effect(name)
        for k, v in FX_PROPS[name].items():
            eff.set(k, v)
        slot.set_effect(eff)
        if name == "convolution":
            ir = ctx.create_buffer()
            ir.set_data(conv_ir(seed), "mono", "float32", RATE)
            slot.set_buffer(ir)
        slots.append(slot)
    rev = None
    if reverb:
        rev = ctx.create_aux_slot()
        rev.set_effect(ctx.create_effect("eaxreverb"))
    rng = np.random.default_rng(seed)
    bufs = []
    for tone in tone_pool(N_TONES):
        buf = ctx.create_buffer()
        buf.set_data(tone, "mono", "float32", RATE)
        bufs.append(buf)
    for i in range(n_voices):
        src = ctx.create_source()
        src.buffer(bufs[i % N_TONES])
        src.looping = True
        src.set("position", tuple(rng.standard_normal(3) * 3.0))
        src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
        src.send(slots[i % len(slots)], 0)
        if rev is not None:
            src.send(rev, 1)
        src.play()
    return dev


def scan_inputs(rng, B: int, T: int, device):
    """A wet line per row, its level sweeping 0.05..1.5 (so that the
    envelopes rise and fall and the swept filter's w0 reaches its clamp)."""
    import torch

    level = np.linspace(0.05, 1.5, T) * (1.0 + 0.5 * np.sin(
        np.arange(T) * (2 * np.pi / max(T // 3, 1))))
    x = rng.standard_normal((B, T)) * level
    return torch.tensor(x.astype(np.float32), device=device)


def swept_coeffs(envs, bandwidth: float = 0.5, fmin: float = 20.0 / RATE,
                 rg: float = 1.6):
    """The autowah's per-sample normalised coefficients [5, T] from its
    envelopes, computed by torch as effects/autowah.py computes them."""
    import torch

    w0 = torch.clamp(bandwidth * envs + fmin, max=0.46) * (2.0 * np.pi)
    cos_w0, alpha = torch.cos(w0), torch.sin(w0) * 0.1
    a0r = 1.0 / (1.0 + alpha / rg)
    b1 = -2.0 * cos_w0
    return torch.stack([(1.0 + alpha * rg) * a0r, b1 * a0r,
                        (1.0 - alpha * rg) * a0r, b1 * a0r,
                        (1.0 - alpha / rg) * a0r]).contiguous()


def check_effect_scan(cuda) -> float:
    """Phase 21: every effect_scan entry bit-equal to its plain version,
    outputs and carried state over two calls: T 128, 1024 and 16384; B 1,
    4 and 9; the compressor on and off; the autowah's attack above and
    below its release; swept coefficients whose w0 crosses its 0.46
    clamp."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import effect_scan as es

    rng = np.random.default_rng(12)
    am = np.float32(4.0 ** (1.0 / (RATE * 0.1)))
    rm = np.float32(0.25 ** (1.0 / (RATE * 0.2)))

    def record(row, got, want):
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        emit({"phase": "kernel", "name": "effect_scan", **row, "calls": 2,
              "max_abs_err": err, "bit_equal": equal})
        if not equal:
            raise AssertionError(f"effect_scan != plain at {row}: {err}")
        return err

    def two_calls(fn, ref, xs, state):
        got = want = (None, state)
        outs_g, outs_w = [], []
        for x in xs:
            got = fn(x, got[1])
            want = ref(x, want[1])
            outs_g.append(got[0])
            outs_w.append(want[0])
        torch.cuda.synchronize()
        return outs_g + [got[1]], outs_w + [want[1]]

    max_err = 0.0
    for T in (128, 1024, 16384):
        for B in (1, 4, 9):
            xs = [scan_inputs(rng, B, T, cuda) for _ in range(2)]
            env0 = torch.tensor(rng.uniform(0.5, 2.0, B).astype(np.float32),
                                device=cuda)
            prm = torch.tensor([am, rm], device=cuda)
            for on in (True, False):
                amps = [x.abs().clamp(0.5, 2.0) if on else torch.ones_like(x)
                        for x in xs]
                g, w = two_calls(lambda a, e: es.compressor_env(a, e, prm),
                                 lambda a, e: es.compressor_env_ref(a, e, prm),
                                 amps, env0)
                max_err = max(max_err, record(
                    {"entry": "compressor_env", "B": B, "T": T,
                     "compressor_on": on}, g, w))
            for att, rel in ((0.9995, 0.995), (0.995, 0.9995)):
                prm = torch.tensor([1.3, att, rel], dtype=torch.float32,
                                   device=cuda)
                g, w = two_calls(lambda x, e: es.autowah_env(x, e, prm),
                                 lambda x, e: es.autowah_env_ref(x, e, prm),
                                 xs, torch.zeros(B, device=cuda))
                max_err = max(max_err, record(
                    {"entry": "autowah_env", "B": B, "T": T,
                     "attack_above_release": att > rel}, g, w))
            envs = [es.autowah_env_ref(x[:1], torch.zeros(1, device=cuda),
                                       prm)[0][0] for x in xs]
            cfs = [swept_coeffs(e) for e in envs]
            clamped = int(sum(int((0.5 * e + 20.0 / RATE >= 0.46).sum())
                              for e in envs))
            got = want = (None, torch.zeros((B, 2), device=cuda))
            outs = ([], [])
            for x, cf in zip(xs, cfs):
                got = es.swept_tdf2(x, cf, got[1])
                want = es.swept_tdf2_ref(x, cf, want[1])
                outs[0].append(got[0])
                outs[1].append(want[0])
            torch.cuda.synchronize()
            max_err = max(max_err, record(
                {"entry": "swept_tdf2", "B": B, "T": T,
                 "samples_at_clamp": clamped},
                outs[0] + [got[1]], outs[1] + [want[1]]))
            if T >= 1024 and clamped == 0:
                raise AssertionError("the swept case never reached the "
                                     "0.46 clamp")
    return max_err


def check_biquad_effect_shapes(cuda) -> float:
    """Phase 22: the biquad kernel in the effects' shapes, bit-equal to its
    plain version over two calls: the equalizer's four-section constant
    cascade at B 4 and 9 (T 1024), and one section beside an identity
    section at 4T = 4096 (the distortion's oversampled lines)."""
    import torch

    from openal_soft_tpu_torch.ops import spec
    from openal_soft_tpu_torch.ops.kernels import biquad as biq

    rng = np.random.default_rng(13)
    eq = np.stack([spec.biquad_set_params(k, np.float32(f), np.float32(g),
                                          np.float32(q))
                   for k, f, g, q in (("lowshelf", 0.004, 1.41, 0.9),
                                      ("peaking", 0.0146, 0.63, 1.2),
                                      ("peaking", 0.0625, 1.2, 1.0),
                                      ("highshelf", 0.125, 1.22, 0.9))])
    lp = spec.biquad_set_params("lowpass", np.float32(0.03), np.float32(1.0),
                                np.float32(0.8))
    ident = np.array([1.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    max_err = 0.0
    for label, B, T, cf in (("equalizer", 4, BLOCK, eq),
                            ("equalizer", 9, BLOCK, eq),
                            ("identity_padded", 4, 4 * BLOCK,
                             np.stack([lp, ident]))):
        S = cf.shape[0]
        cft = torch.tensor(np.broadcast_to(cf, (B, S, 5)).copy(),
                           device=cuda)
        cnt = torch.zeros(B, dtype=torch.int32, device=cuda)
        got = want = (None, torch.zeros((B, S, 2), device=cuda))
        outs = ([], [])
        for _ in range(2):
            x = torch.tensor((rng.standard_normal((B, T)) * 0.5).astype(
                np.float32), device=cuda)
            got = biq.biquad_dual(x, got[1], cft, cft, cnt)
            want = biq.biquad_dual_ref(x, want[1], cft, cft, cnt)
            outs[0].append(got[0])
            outs[1].append(want[0])
        torch.cuda.synchronize()
        a, b = outs[0] + [got[1]], outs[1] + [want[1]]
        equal = all(torch.equal(u, v) for u, v in zip(a, b))
        err = max(float((u.double() - v.double()).abs().max())
                  for u, v in zip(a, b))
        emit({"phase": "kernel", "name": "biquad", "shape": label, "V": B,
              "T": T, "sections": S, "calls": 2, "max_abs_err": err,
              "bit_equal": equal})
        if not equal:
            raise AssertionError(f"biquad != plain at {label} B={B}: {err}")
        max_err = max(max_err, err)
    return max_err


# Cycles of each entry's loop-carried chain per sample, counted from
# csrc/effect_scan.cu at Hopper's 4-cycle dependent FP32 latency: the
# swept TDF2's z0 -> y -> z0 is add, mul, sub, add (16); the autowah's env
# -> env is a compare feeding a select, then mul and add (16); the
# compressor's env -> env is mul, min/max and a select (12).
SCAN_CHAIN_CYCLES = {"compressor_env": 12, "autowah_env": 16,
                     "swept_tdf2": 16}
# Float operations per line-sample of each entry, and the floats it moves
# per line-sample (input and output) beside its per-line state.
SCAN_FLOPS = {"compressor_env": 5, "autowah_env": 5, "swept_tdf2": 9}


def scan_bound(entry: str, B: int, T: int) -> tuple[float, str]:
    """An effect_scan call: its input and output lines read and written
    once (and the swept filter's five coefficient rows), against its
    operations."""
    floats = 2 * B * T + (5 * T if entry == "swept_tdf2" else 0) + 4 * B
    return bound(4 * floats, SCAN_FLOPS[entry] * B * T)


def phase_effect_scan_timings(cuda, report: dict, smi: str) -> None:
    """Phase 23: each effect_scan entry alone (CUDA events over 20 raw
    launches, previous, new, new, previous where the build directory
    holds parent/effect_scan.cu) and through its wrapper, at B 4 and 9 and
    T 1024 and 16384, beside its bound and its chain floor (T x the
    chain's cycles over the SM clock from the biquad kernel's probe); its
    plain version at T 1024.  The JSON line's effect_scan row sums the
    three entries at fx_rack's per-block shapes (the compressor and
    autowah envelopes of one line, the swept filter over 9 lines)."""
    import ctypes

    import torch

    from openal_soft_tpu_torch.ops.kernels import _build
    from openal_soft_tpu_torch.ops.kernels import biquad as biq
    from openal_soft_tpu_torch.ops.kernels import effect_scan as es

    cycles, ns = biq.chain_probe(1 << 20, cuda)
    ghz = cycles / ns
    libs = {"new": _build.load_library("effect_scan")}
    parent = parent_kernel("effect_scan")
    if parent is not None:
        libs["parent"] = parent
    rng = np.random.default_rng(14)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fx_shapes = {"compressor_env": 1, "autowah_env": 1, "swept_tdf2": 9}
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    by = set()
    for B in (4, 9, 1):
        for T in (BLOCK, 16 * BLOCK):
            if B == 1 and T != BLOCK:
                continue
            x = scan_inputs(rng, B, T, cuda)
            env = torch.ones(B, device=cuda)
            prm = {"compressor_env": torch.tensor([1.0003, 0.9998],
                                                  device=cuda),
                   "autowah_env": torch.tensor([1.3, 0.999, 0.9995],
                                               device=cuda)}
            cf = swept_coeffs(es.autowah_env_ref(
                x[:1], torch.zeros(1, device=cuda), prm["autowah_env"])[0][0])
            z = torch.zeros((B, 2), device=cuda)
            out = torch.empty_like(x)
            st = torch.empty(B, 2, device=cuda)
            for entry in SCAN_CHAIN_CYCLES:
                if entry == "swept_tdf2":
                    ptrs = [x, cf, z, out, st]
                    wrap = lambda: es.swept_tdf2(x, cf, z)  # noqa: E731
                    plain = lambda: es.swept_tdf2_ref(x, cf, z)  # noqa: E731
                else:
                    a = x.abs().clamp(0.5, 2.0) if entry == "compressor_env" \
                        else x
                    ptrs = [a, env, prm[entry], out, st]
                    fn = getattr(es, entry)
                    ref = getattr(es, entry + "_ref")
                    wrap = (lambda fn=fn, a=a, p=prm[entry]:
                            fn(a, env, p))
                    plain = (lambda ref=ref, a=a, p=prm[entry]:
                             ref(a, env, p))
                times = {}
                for key, which in (("parent_ms", "parent"), ("ms", "new"),
                                   ("ms_2", "new"),
                                   ("parent_ms_2", "parent")):
                    if which not in libs:
                        continue
                    raw = getattr(libs[which], f"{entry}_launch")
                    raw.argtypes = [ctypes.c_void_p] * 5 + [
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                    raw.restype = ctypes.c_int
                    args = [t.data_ptr() for t in ptrs] + [B, T, stream]
                    times[key] = cuda_ms(lambda: raw(*args), 20, 3)
                times["wrapper_ms"] = cuda_ms(wrap, 20, 3)
                bound_ms, bound_by = scan_bound(entry, B, T)
                row = {"phase": "timing", "name": "effect_scan",
                       "entry": entry, "B": B, "T": T, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       "chain_floor_ms": T * SCAN_CHAIN_CYCLES[entry]
                       / ghz * 1e-6, "sm_GHz": ghz, "nvidia_smi": smi}
                if T == BLOCK:
                    row["plain_ms"] = cuda_ms(plain, 1, 1)
                emit(rates(row, times, 4 * B * T, bound_ms))
                if T == BLOCK and B == fx_shapes[entry]:
                    total["ms"] += times["ms"]
                    total["plain_ms"] += row["plain_ms"]
                    total["bound_ms"] += bound_ms
                    by.add(bound_by)
    report["effect_scan"].update(
        total, bound_by="bytes" if by == {"bytes"} else "operations")


def launches_per_block(dev, frames: int) -> float:
    """Device operations (kernels, copies, fills) per 1024-frame block of
    one render call, counted by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        dev.render_samples(frames)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA)
    return n / (frames / BLOCK)


def engine_costs(dev) -> dict:
    """Each slot's engine alone over one 1024-sample block of noise on its
    wet bus (the scene's parameters and state): the device operations it
    issues (torch.profiler) and its wall ms with the card synchronised
    (median of 5)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    wet = torch.randn((dev.wet_channels, BLOCK), device="cuda") * 0.1
    costs = {}
    for i, slot in enumerate(dev.slots):
        run = lambda: slot.state.process(  # noqa: E731
            dev._state[f"slot{i}"], dev._cfg_dev[f"slot{i}"], wet, BLOCK)
        run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]
                                    ) as prof:
            run()
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        costs[slot.effect_type] = {"device_ops": ops,
                                   "wall_ms": float(np.median(walls))}
    return costs


def phase_fx_rack(wrappers: dict, report: dict, smi: str, seed: int) -> None:
    """Phase 24: fx_rack at full width through the port's entry points: a
    game's EFX zones on 5.1 speakers, with every engine a game can select
    live at once.  One warm 512-block call, one timed; then the device
    operations per block over 8 blocks."""
    import torch

    from openal_soft_tpu_torch.core.devformat import Channel
    from openal_soft_tpu_torch.effects import effect_registry

    engines = sorted(set(effect_registry) - {"null", "reverb",
                                               "eaxreverb"})
    if engines != sorted(FX_ENGINES):
        raise AssertionError(f"fx_rack's engines {sorted(FX_ENGINES)} are "
                             f"not the registry's {engines}")
    frames = CHUNK_BLOCKS * BLOCK
    t0 = time.perf_counter()
    dev = fx_rack_scene(N_VOICES, "cuda", seed)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev.render_samples(frames)                       # warm
    warm_s = time.perf_counter() - t0
    for name in KERNELS:
        wrappers[name].launches = 0
    t0 = time.perf_counter()
    out = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in KERNELS}
    report["effect_scan"]["launches"] = launches["effect_scan"]
    per_block = launches_per_block(dev, 8 * BLOCK)
    emit({"phase": "fx_rack", "engine_costs_per_block": engine_costs(dev),
          "nvidia_smi": smi})
    idx = dev.layout.channel_index
    fc, lfe = idx[Channel.FRONT_CENTER], idx[Channel.LFE]
    finite = bool(np.isfinite(out).all())
    peak = float(np.abs(out).max())
    emit({"phase": "fx_rack", "voices": N_VOICES, "slots": len(dev.slots),
          "frames": frames, "setup_s": setup_s, "warm_s": warm_s,
          "render_s": dt, "ms_per_call": 1e3 * dt,
          "x_realtime": (frames / RATE) / dt,
          "device_ops_per_block": per_block, "launches": launches,
          "finite": finite, "peak": peak,
          "fc_peak": float(np.abs(out[:, fc]).max()),
          "lfe_peak": float(np.abs(out[:, lfe]).max()),
          "shape": list(out.shape), "nvidia_smi": smi})
    if (out.shape != (frames, 6) or not finite or not peak > 0.0
            or not np.abs(out[:, fc]).max() > 0.0
            or not np.abs(out[:, lfe]).max() > 0.0):
        raise AssertionError("fx_rack output is not finite, nonzero "
                             f"[{frames}, 6] with FC and LFE: shape "
                             f"{out.shape}, finite {finite}, peak {peak}")
    if not all(launches[k] > 0 for k in ("effect_scan", "resample_gen",
                                         "reverb", "biquad")):
        raise AssertionError(f"fx_rack skipped a kernel: {launches}")


def phase_fx_parity(wrappers: dict, seed: int) -> None:
    """Phase 25: each engine at 64 voices on the card against the port on
    the CPU, on stereo, the dedicated engines also on surround51, and the
    equalizer, echo and pitch shifter on an HRTF device (the fused
    branch, slots in 1024-sample sub-windows): multi-block (8192 frames)
    and per-block (4096), <= 1e-4 (1e-3 with the pitch shifter)."""
    cases = [(name, "stereo", False, (name,)) for name in FX_ENGINES]
    cases += [(name + "_51", "surround51", False, (name,))
              for name in ("dedicated_dialog", "dedicated_lfe")]
    cases += [("hrtf_eq_echo_pshift", "stereo", True,
               ("equalizer", "echo", "pitch_shifter"))]
    for label, channels, hrtf, engines in cases:
        kw = dict(engines=engines, reverb=False, channels=channels,
                  hrtf=hrtf)
        g = fx_rack_scene(64, "cuda", seed, **kw)
        c = fx_rack_scene(64, "cpu", seed, **kw)
        if hrtf and not g._fused(g._graph_gates()):
            raise AssertionError(f"{label} does not take the fused branch")
        tol = FX_PSHIFT_TOL if "pitch_shifter" in engines else FX_TOL
        before = {k: wrappers[k].launches for k in KERNELS}
        for n, path in ((8192, "multi-block"), (4096, "per-block")):
            a, b = g.render_samples(n), c.render_samples(n)
            err = float(np.abs(a - b).max())
            emit({"phase": "parity", "scene": label, "frames": n,
                  "path": "fused" if hrtf and n == 8192 else path,
                  "channels": int(b.shape[1]), "max_abs_err": err,
                  "tol": tol, "peak": float(np.abs(b).max())})
            if not (np.isfinite(a).all() and err <= tol
                    and np.abs(b).max() > 1e-3):
                raise AssertionError(f"{label} GPU vs CPU port at {n} "
                                     f"frames: {err}")
        need = {FX_KERNELS[e] for e in engines if e in FX_KERNELS}
        grew = {k: wrappers[k].launches - before[k] for k in KERNELS}
        if not all(grew[k] > 0 for k in need):
            raise AssertionError(f"{label} skipped a kernel: {grew}")


# --- the AL/ALC entry points and the playback lifecycle (phases 26-28) -------

# The torch device of phases 26-28's full-width scenes, and the type that
# alcOpenDevice's default device must resolve to.
CARD = "cuda"
API_SCENES = {"best_case": ({}, ("resample_unit",)),
              "speakers_filtered": ({"loaded": True, "filtered": True,
                                     "hrtf": False},
                                    ("resample_gen", "reverb", "biquad"))}


def reset_counts(wrappers: dict) -> None:
    for name in KERNELS:
        wrappers[name].launches = 0


def counts(wrappers: dict) -> dict:
    return {name: wrappers[name].launches for name in KERNELS}


def wall(fn):
    """(fn's result, its wall seconds); a render ends in a host copy."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_api(wrappers: dict, smi: str) -> np.ndarray:
    """Phase 26: best_case and speakers_filtered at full width built only
    through the AL/ALC entry points, each bit-equal to bench_scene's build
    of the same scene over a warm and a timed 512-block call.  Returns the
    API speakers_filtered scene's first call, for phase 27."""
    from openal_soft_tpu_torch.al import api as al

    frames = CHUNK_BLOCKS * BLOCK
    first = None
    for scene, (kw, need) in API_SCENES.items():
        direct, direct_s = wall(lambda: bench_scene(N_VOICES, N_VOICES,
                                                    CARD, **kw))
        dev, api_s = wall(lambda: api_open_loopback(
            N_VOICES, CARD, hrtf=kw.get("hrtf", True)))
        (ctx, sids), scene_s = wall(lambda: api_scene(
            dev, N_VOICES, loaded=kw.get("loaded", False),
            filtered=kw.get("filtered", False)))
        api_s += scene_s
        err = al.alGetError()
        warm = (al.alcRenderSamplesSOFT(dev, frames),
                direct.render_samples(frames))
        before = [al.alGetSourcei(s, al.AL_SAMPLE_OFFSET) for s in sids]
        reset_counts(wrappers)
        out_api, api_r = wall(lambda: al.alcRenderSamplesSOFT(dev, frames))
        launches = counts(wrappers)
        out_direct, direct_r = wall(lambda: direct.render_samples(frames))
        diff = max(float(np.abs(warm[0] - warm[1]).max()),
                   float(np.abs(out_api - out_direct).max()))
        (states, offsets), poll_s = wall(lambda: (
            [al.alGetSourcei(s, al.AL_SOURCE_STATE) for s in sids],
            [al.alGetSourcei(s, al.AL_SAMPLE_OFFSET) for s in sids]))
        clock = al.alcGetInteger64vSOFT(dev, al.ALC_DEVICE_CLOCK_SOFT)
        advanced = sum(a != b for a, b in zip(offsets, before))
        emit({"phase": "api", "scene": scene, "voices": N_VOICES,
              "frames": frames, "build_s": {"api": api_s,
                                            "direct": direct_s},
              "render_s": {"api": api_r, "direct": direct_r},
              "x_realtime": {"api": (frames / RATE) / api_r,
                             "direct": (frames / RATE) / direct_r},
              "max_abs_diff": diff, "al_error": err,
              "playing": states.count(al.AL_PLAYING),
              "offsets_advanced": advanced, "device_clock_ns": clock,
              "poll_ms": 1e3 * poll_s, "launches": launches,
              "peak": float(np.abs(out_api).max()), "nvidia_smi": smi})
        if diff != 0.0 or err != al.AL_NO_ERROR:
            raise AssertionError(f"{scene} through the API differs from "
                                 f"the direct build by {diff} (AL error "
                                 f"{err:#x})")
        if (states.count(al.AL_PLAYING) != N_VOICES
                or advanced != N_VOICES
                or clock != 2 * frames * 1_000_000_000 // RATE):
            raise AssertionError(f"{scene}: {states.count(al.AL_PLAYING)} "
                                 f"playing, {advanced} offsets advanced, "
                                 f"clock {clock}")
        if not (np.isfinite(out_api).all() and np.abs(out_api).max() > 0):
            raise AssertionError(f"{scene} through the API is silent or "
                                 "not finite")
        if not all(launches[k] > 0 for k in need):
            raise AssertionError(f"{scene} through the API skipped a "
                                 f"kernel: {launches}")
        if scene == "speakers_filtered":
            first = warm[0]
        del direct, dev, ctx, warm, out_api, out_direct
    return first


def eax_scene(n_voices: int, device: str):
    """The API speakers_filtered scene with EAX 2.0 on top: the hangar
    environment, and -1200 mB of occlusion on every other source."""
    from openal_soft_tpu_torch.al import api as al
    from openal_soft_tpu_torch.al import eax

    dev = api_open_loopback(n_voices, device, hrtf=False)
    ctx, sids = api_scene(dev, n_voices, loaded=True, filtered=True)
    al.EAXSet(eax.DSPROPSETID_EAX20_ListenerProperties, eax.L20_ENVIRONMENT,
              0, 10)
    for sid in sids[::2]:
        al.EAXSet(eax.DSPROPSETID_EAX20_BufferProperties, eax.B20_OCCLUSION,
                  sid, -1200)
    return dev


def phase_eax(wrappers: dict, smi: str, plain: np.ndarray) -> None:
    """Phase 27: the EAX scene at full width renders finite and unlike the
    same scene without EAX (``plain``, phase 26's first call); at 64
    voices the card agrees with the CPU within SPEAKERS_TOL."""
    from openal_soft_tpu_torch.al import api as al

    frames = CHUNK_BLOCKS * BLOCK
    dev, build_s = wall(lambda: eax_scene(N_VOICES, CARD))
    err = al.alGetError()
    reset_counts(wrappers)
    out, render_s = wall(lambda: al.alcRenderSamplesSOFT(dev, frames))
    launches = counts(wrappers)
    diff = float(np.abs(out - plain).max())
    emit({"phase": "eax", "voices": N_VOICES, "frames": frames,
          "build_s": build_s, "render_s": render_s,
          "x_realtime": (frames / RATE) / render_s, "slots": len(dev.slots),
          "max_abs_diff_without_eax": diff, "al_error": err,
          "launches": launches, "peak": float(np.abs(out).max()),
          "nvidia_smi": smi})
    if not (np.isfinite(out).all() and diff > 1e-3
            and err == al.AL_NO_ERROR):
        raise AssertionError(f"EAX scene: finite {np.isfinite(out).all()}, "
                             f"{diff} from the plain scene, AL error {err}")
    if not all(launches[k] > 0 for k in ("resample_gen", "reverb",
                                         "biquad")):
        raise AssertionError(f"EAX scene skipped a kernel: {launches}")
    del dev, out
    g, c = eax_scene(64, CARD), eax_scene(64, "cpu")
    for n, path in ((8192, "multi-block"), (4096, "per-block"),
                    (100, "odd"), (924, "odd")):
        a, b = g.render_samples(n), c.render_samples(n)
        err = float(np.abs(a - b).max())
        emit({"phase": "parity", "scene": "eax", "frames": n, "path": path,
              "max_abs_err": err, "tol": SPEAKERS_TOL,
              "peak": float(np.abs(b).max())})
        if not (np.isfinite(a).all() and err <= SPEAKERS_TOL):
            raise AssertionError(f"EAX GPU vs CPU port at {n} frames: {err}")


def phase_playback(wrappers: dict, smi: str, periods: int = 8) -> None:
    """Phase 28: the wave writer and the null output through alcOpenDevice
    with the API speakers_filtered scene at full width.  The wave data
    before a reset is bit-equal to a loopback device's render in the same
    1024-frame calls; after alcResetDeviceSOFT the voices play on, on the
    card, connected.  The null output's thread runs ~2 s; its share of
    realtime is printed.  handle_disconnect drops ALC_CONNECTED to 0,
    delivers the event and stops the voices."""
    from openal_soft_tpu_torch.al import api as al
    from openal_soft_tpu_torch.alc import lifecycle

    attrs = [al.ALC_MONO_SOURCES, N_VOICES, 0]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "out.wav")
        with alsoft_conf(f"[wave]\nfile = {path}\n"):
            dev = al.alcOpenDevice(lifecycle.WAVE_DEVICE_NAME, attrs=attrs)
            al.alcDevicePauseSOFT(dev)
            (ctx, sids), build_s = wall(lambda: api_scene(
                dev, N_VOICES, loaded=True, filtered=True))
            reset_counts(wrappers)
            t0 = time.perf_counter()
            for _ in range(periods):
                dev.backend.render(BLOCK)
                # The mixer thread renders whatever periods fall between
                # resume and pause; the file holds them all, in order.
                al.alcDevicePauseSOFT(dev)
                al.alcDeviceResumeSOFT(dev)
                al.alcDevicePauseSOFT(dev)
            wave_s = time.perf_counter() - t0
            launches = counts(wrappers)
            dev.backend._fh.flush()
            written = dev.backend._frames_written
            data = np.fromfile(path, np.float32, offset=44)[:2 * written]
            before = [al.alGetSourcei(s, al.AL_SAMPLE_OFFSET) for s in sids]
            lb = api_open_loopback(N_VOICES, CARD, hrtf=False)
            api_scene(lb, N_VOICES, loaded=True, filtered=True)
            want = np.concatenate([lb.render_samples(BLOCK)
                                   for _ in range(written // BLOCK)])
            diff = float(np.abs(data.reshape(-1, 2) - want).max())
            del lb, want
            al.alcMakeContextCurrent(ctx)
            al.alcResetDeviceSOFT(dev)
            dev.backend.render(BLOCK)
            states = [al.alGetSourcei(s, al.AL_SOURCE_STATE) for s in sids]
            after = [al.alGetSourcei(s, al.AL_SAMPLE_OFFSET) for s in sids]
            moved = sum(a != b for a, b in zip(after, before))
            on = dev.render.torch_device.type
            connected = al.alcGetIntegerv(dev, al.ALC_CONNECTED)
            al.alcCloseDevice(dev)
            del dev, ctx
    emit({"phase": "playback", "device": "wave", "voices": N_VOICES,
          "periods": periods, "frames_written": written,
          "build_s": build_s, "wave_s": wave_s,
          "max_abs_diff_vs_loopback": diff, "launches": launches,
          "after_reset": {"playing": states.count(al.AL_PLAYING),
                          "offsets_moved": moved, "torch_device": on,
                          "connected": connected},
          "nvidia_smi": smi})
    if diff != 0.0 or written < periods * BLOCK or written % BLOCK:
        raise AssertionError(f"wave device: {written} frames, {diff} from "
                             "the loopback render")
    if not all(launches[k] > 0 for k in ("resample_gen", "reverb",
                                         "biquad")):
        raise AssertionError(f"wave device skipped a kernel: {launches}")
    if (states.count(al.AL_PLAYING) != N_VOICES or moved != N_VOICES
            or on != CARD or connected != 1):
        raise AssertionError(f"after the reset: {states.count(al.AL_PLAYING)}"
                             f" playing, {moved} offsets moved, on {on}, "
                             f"connected {connected}")

    dev = al.alcOpenDevice(lifecycle.NULL_DEVICE_NAME, attrs=attrs)
    al.alcDevicePauseSOFT(dev)
    ctx, sids = api_scene(dev, N_VOICES, loaded=True, filtered=True)
    dev.render.render_samples(BLOCK)                 # warm
    start = dev.backend.frames_rendered
    t0 = time.perf_counter()
    al.alcDeviceResumeSOFT(dev)
    time.sleep(2.0)
    al.alcDevicePauseSOFT(dev)
    null_s = time.perf_counter() - t0
    rendered = dev.backend.frames_rendered - start
    share = rendered / (null_s * RATE)
    events = []
    al.alEventCallbackSOFT(lambda *a: events.append(a))
    al.alEventControlSOFT([al.AL_EVENT_TYPE_DISCONNECTED_SOFT], True)
    dev.render.handle_disconnect("output lost")
    connected = al.alcGetIntegerv(dev, al.ALC_CONNECTED)
    deadline = time.time() + 10.0
    while not events and time.time() < deadline:
        time.sleep(0.01)
    stopped = [al.alGetSourcei(s, al.AL_SOURCE_STATE)
               for s in sids].count(al.AL_STOPPED)
    tail = dev.render.render_samples(BLOCK)
    al.alcCloseDevice(dev)
    emit({"phase": "playback", "device": "null", "voices": N_VOICES,
          "wall_s": null_s, "frames_rendered": rendered,
          "realtime_share": share, "connected_after_disconnect": connected,
          "disconnect_events": [list(e) for e in events],
          "stopped": stopped, "nvidia_smi": smi})
    if rendered <= 0 or not np.isfinite(tail).all():
        raise AssertionError(f"null device rendered {rendered} frames")
    if (connected != 0 or stopped != N_VOICES
            or events != [("disconnected", 0, "output lost")]):
        raise AssertionError(f"disconnect: connected {connected}, "
                             f"{stopped} stopped, events {events}")


# --- the offline tools, the C ABI and the examples (phases 29-33) ----------

UHJ_SECONDS = 120          # an album track, 48 kHz FuMa B-Format
UHJ_CHECK_S = {"iir": 2, "fir256": 10, "fir512": 10}   # card vs CPU window
KEMAR_AZ = (1, 12, 24, 36, 45, 56, 60, 72, 72, 72, 72, 72, 60, 56, 45, 36,
            24, 12, 1)          # MIT KEMAR's elevations, -90..90 degrees
KEMAR_EV_START = 5              # measured from -40 degrees up: 710 HRIRs
EXAMPLE_SECONDS = 2.0


def bformat_signal(seconds: float, seed: int) -> np.ndarray:
    """[frames, 4] FuMa WXYZ: three tones circling the listener at
    different rates and heights over a quiet noise bed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * RATE)) / RATE
    out = 0.01 * rng.standard_normal((t.size, 4))
    for f, rate_hz, elev in ((220.0, 0.05, 0.0), (330.0, -0.11, 0.4),
                             (523.0, 0.23, -0.3)):
        s = 0.2 * np.sin(2 * np.pi * f * t) * (0.6 + 0.4 * np.sin(
            2 * np.pi * rng.uniform(0.05, 0.3) * t))
        az = 2 * np.pi * rate_hz * t + rng.uniform(0, 2 * np.pi)
        out += np.stack([s * np.sqrt(0.5), s * np.cos(az) * np.cos(elev),
                         s * np.sin(az) * np.cos(elev),
                         s * np.sin(elev) * np.ones_like(t)], 1)
    return out.astype(np.float32)


def phase_uhj_tools(wrappers: dict, smi: str) -> None:
    """Phase 29: the UHJ encoder and decoder over a 120-s B-Format track:
    the iir tier through the tool's command line (K7 must launch), fir256
    and fir512 through encode(), the iir result decoded at both tiers;
    each tier's head on the card against the CPU within UHJ_TOL."""
    from openal_soft_tpu_torch.utils import uhjdecoder as dec
    from openal_soft_tpu_torch.utils import uhjencoder as enc

    sig = bformat_signal(UHJ_SECONDS, 29)
    seconds = sig.shape[0] / RATE
    with tempfile.TemporaryDirectory() as d:
        src, uhj = os.path.join(d, "track.amb.wav"), os.path.join(d, "u.wav")
        enc._write_wav(src, sig, RATE)
        data, _ = enc._read_wav(src)
        reset_counts(wrappers)
        _, iir_s = wall(lambda: enc.main([src, uhj, "--tier", "iir",
                                              "--device", CARD]))
        launches = counts(wrappers)
        encoded, _ = enc._read_wav(uhj)
        results = {"encode iir": (encoded, iir_s)}
        for tier in ("fir256", "fir512"):
            results[f"encode {tier}"] = wall(lambda: enc.encode(data, tier,
                                                              CARD))
        for tier in ("fir256", "fir512"):
            out = os.path.join(d, f"b_{tier}.wav")
            _, dec_s = wall(lambda: dec.main([uhj, out, "--tier", tier,
                                                 "--device", CARD]))
            results[f"decode {tier}"] = (dec._read_wav(out)[0], dec_s)
    for key, (out, sec) in results.items():
        what, tier = key.split()
        m = int(UHJ_CHECK_S[tier] * RATE)
        fn = (lambda x, dev: enc.encode(x, tier, dev)) if what == "encode" \
            else (lambda x, dev: dec.decode(x, tier, dev))
        head = (data if what == "encode" else encoded)[:m]
        err = float(np.abs(fn(head, CARD) - fn(head, "cpu")).max())
        finite = bool(np.isfinite(out).all())
        peak = float(np.abs(out).max())
        emit({"phase": "uhj_tools", "tool": what, "tier": tier,
              "seconds": seconds, "frames": int(out.shape[0]),
              "channels": int(out.shape[1]), "wall_s": sec,
              "x_realtime": seconds / sec, "check_s": m / RATE,
              "max_abs_err_vs_cpu": err, "tol": UHJ_TOL, "peak": peak,
              **({"launches": launches} if key == "encode iir" else {}),
              "nvidia_smi": smi})
        if not (finite and peak > 0.0 and out.shape[0] == sig.shape[0]):
            raise AssertionError(f"{key}: finite {finite}, peak {peak}, "
                                 f"shape {out.shape}")
        if not err <= UHJ_TOL:
            raise AssertionError(f"{key}: card vs CPU {err} > {UHJ_TOL}")
    if launches["biquad"] <= 0:
        raise AssertionError(f"the iir encoder skipped biquad: {launches}")


def kemar_set(seed: int):
    """A seeded HRIR set on the MIT KEMAR grid (44.1 kHz, 512 taps, one
    field at 1.4 m): each measured ear's response is decaying noise after
    an onset that grows with the ear's distance from the source; the rings
    below KEMAR_EV_START are left to makemhr to synthesize."""
    from openal_soft_tpu_torch.utils import makemhr

    rng = np.random.default_rng(seed)
    taps, rate = 512, 44100
    irs = np.zeros((sum(KEMAR_AZ), 2, taps))
    n = np.arange(taps)
    row = 0
    for ei, azn in enumerate(KEMAR_AZ):
        elev = -np.pi / 2 + np.pi * ei / (len(KEMAR_AZ) - 1)
        for ai in range(azn):
            lat = np.sin(2 * np.pi * ai / azn) * np.cos(elev)
            for ear, side in ((0, 1.0), (1, -1.0)):
                onset = 24.0 + 14.0 * (1.0 + side * lat)
                env = np.exp(-np.maximum(n - onset, 0.0) / 18.0) * (n >= onset)
                if ei >= KEMAR_EV_START:
                    irs[row + ai, ear] = (env * rng.standard_normal(taps)
                                          * (1.2 - 0.5 * side * lat))
        row += azn
    return makemhr.HrirSet(rate, [(1.4, list(KEMAR_AZ))], irs,
                           ev_starts=[KEMAR_EV_START])


def phase_makemhr(wrappers: dict, smi: str) -> None:
    """Phase 30: makemhr on a KEMAR-grid set (the gap below -40 degrees
    synthesized), selected through alsoft.conf, rendering best_case at
    full width: K1 must launch, and the output must differ from the same
    scene on the default data set."""
    from openal_soft_tpu_torch.utils import makemhr

    frames = CHUNK_BLOCKS * BLOCK
    with tempfile.TemporaryDirectory() as d:
        hset = kemar_set(30)
        path = os.path.join(d, "kemar_synth.mhr")
        _, host_s = wall(lambda: makemhr.process_hrir_set(hset, path))
        size = os.path.getsize(path)
        with alsoft_conf(f"hrtf-paths = {d}\ndefault-hrtf = kemar_synth\n"):
            dev, build_s = wall(lambda: bench_scene(N_VOICES, N_VOICES, CARD))
        hrirs = int(dev.hrtf_store.coeffs.shape[0])
        warm = dev.render_samples(frames)
        reset_counts(wrappers)
        out, render_s = wall(lambda: dev.render_samples(frames))
        launches = counts(wrappers)
        del dev
    base = bench_scene(N_VOICES, N_VOICES, CARD)
    diff = float(np.abs(base.render_samples(frames) - warm).max())
    del base
    finite = bool(np.isfinite(out).all() and np.isfinite(warm).all())
    peak = float(np.abs(out).max())
    emit({"phase": "makemhr", "irs": int(hset.irs.shape[0]),
          "measured": int(sum(KEMAR_AZ[KEMAR_EV_START:])),
          "ev_start": KEMAR_EV_START, "mhr_bytes": size,
          "makemhr_host_s": host_s, "store_hrirs": hrirs,
          "voices": N_VOICES, "frames": frames, "build_s": build_s,
          "render_s": render_s, "x_realtime": (frames / RATE) / render_s,
          "launches": launches, "peak": peak,
          "max_abs_diff_vs_default_set": diff, "nvidia_smi": smi})
    if hrirs != sum(KEMAR_AZ) or not (finite and peak > 0.0):
        raise AssertionError(f"makemhr set: {hrirs} HRIRs, finite {finite}, "
                             f"peak {peak}")
    if not diff > 1e-3:
        raise AssertionError(f"the makemhr set renders as the default set "
                             f"({diff})")
    if launches["resample_unit"] <= 0:
        raise AssertionError(f"makemhr best_case skipped resample_unit: "
                             f"{launches}")


def phase_openal_info(smi: str) -> None:
    """Phase 31: the device lister's command line on the card."""
    import torch

    res, sec = wall(lambda: subprocess.run(
        [sys.executable, "-m", "openal_soft_tpu_torch.utils.openal_info",
         "--device", CARD],
        capture_output=True, text=True, timeout=300))
    name = torch.cuda.get_device_name(0)
    lines = res.stdout.splitlines()
    effects = next((ln for ln in lines if ln.startswith("effects (")), "")
    presets = next((ln for ln in lines if ln.startswith("reverb presets")),
                   "")
    emit({"phase": "openal_info", "rc": res.returncode, "wall_s": sec,
          "device_line": next((ln for ln in lines if "device:" in ln), ""),
          "effects": effects[:40], "presets": presets[:40],
          "nvidia_smi": smi})
    if (res.returncode != 0 or name not in res.stdout
            or not effects.startswith("effects (17)")
            or not presets.startswith("reverb presets (113)")):
        raise AssertionError(f"openal_info: rc {res.returncode}\n"
                             f"{res.stdout[-2000:]}{res.stderr[-3000:]}")


def best_case_voices(n_voices: int) -> np.ndarray:
    """api_scene's best_case positions: seed 42, one 3-vector draw per
    voice, scaled by 3."""
    rng = np.random.default_rng(42)
    return np.array([rng.standard_normal(3) * 3.0 for _ in range(n_voices)])


def cabi_scene(lib, n_voices: int):
    """best_case through the C ABI from this process (ctypes): the calls
    scene_client makes.  Returns the device handle."""
    import ctypes as ct

    u, i, p = ct.c_uint, ct.c_int, ct.c_void_p
    for name, res, args in (
            ("alcLoopbackOpenDeviceSOFT", p, [ct.c_char_p]),
            ("alcCreateContext", p, [p, p]),
            ("alcMakeContextCurrent", ct.c_char, [p]),
            ("alGenBuffers", None, [i, ct.POINTER(u)]),
            ("alBufferData", None, [u, i, p, i, i]),
            ("alGenSources", None, [i, ct.POINTER(u)]),
            ("alSourcei", None, [u, i, i]),
            ("alSource3dSOFT", None, [u, i, ct.c_double, ct.c_double,
                                      ct.c_double]),
            ("alSourcePlay", None, [u]),
            ("alcRenderSamplesSOFT", None, [p, p, i]),
            ("alcCloseDevice", ct.c_char, [p])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    dev = lib.alcLoopbackOpenDeviceSOFT(None)
    if not dev:
        raise AssertionError("alcLoopbackOpenDeviceSOFT returned NULL")
    attrs = (ct.c_int * 11)(0x1007, RATE, 0x1990, 0x1501, 0x1991, 0x1406,
                            0x1992, 1, 0x1010, n_voices, 0)
    lib.alcMakeContextCurrent(lib.alcCreateContext(dev, attrs))
    bufs = []
    for tone in tone_pool(N_TONES):
        b = ct.c_uint()
        lib.alGenBuffers(1, ct.byref(b))
        lib.alBufferData(b.value, 0x10010, tone.ctypes.data_as(ct.c_void_p),
                         tone.nbytes, RATE)
        bufs.append(b.value)
    for i, pos in enumerate(best_case_voices(n_voices)):
        s = ct.c_uint()
        lib.alGenSources(1, ct.byref(s))
        lib.alSourcei(s.value, 0x1009, bufs[i % N_TONES])  # AL_BUFFER
        lib.alSourcei(s.value, 0x1007, 1)                  # AL_LOOPING
        lib.alSource3dSOFT(s.value, 0x1004, *pos)          # AL_POSITION
        lib.alSourcePlay(s.value)
    return dev


def cabi_render(lib, dev, frames: int) -> np.ndarray:
    import ctypes as ct

    out = np.full((frames, 2), np.nan, np.float32)
    lib.alcRenderSamplesSOFT(dev, out.ctypes.data_as(ct.c_void_p), frames)
    return out


def phase_c_abi(wrappers: dict, smi: str) -> None:
    """Phase 32: the C ABI on the card.  test_shim's four scenarios (capture
    from a fake libasound); best_case at full width built by the C program
    scene_client from phase 26's seed and draw order, and by this process
    through the same library, both bit-equal to the al.api build over a
    warm and a timed 512-block call, K1 launched; the int16 output's
    limiter is the native one."""
    import ctypes as ct

    from openal_soft_tpu_torch.al import api as al
    from openal_soft_tpu_torch.alc.device import LoopbackDevice
    from openal_soft_tpu_torch.native import build as native
    from openal_soft_tpu_torch.native import scene

    frames = CHUNK_BLOCKS * BLOCK
    with tempfile.TemporaryDirectory() as d:
        fake = os.path.join(d, "libfakeasound.so")
        subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", fake,
                        os.path.join(os.path.dirname(os.path.abspath(
                            __file__)), "tests", "fake_alsa.c")],
                       check=True, timeout=120)
        shim, shim_s = wall(lambda: subprocess.run(
            [NATIVE_BUILD["files"]["test_shim"]], capture_output=True,
            text=True, timeout=600,
            env=native.client_env(CARD, OPENAL_TPU_ALSA_LIB=fake)))
        markers = [m for m in ("PEAK=", "STREAM_PEAK=", "CAPTURED=",
                               "EAX_DECAY=") if m in shim.stdout]
        emit({"phase": "c_abi", "client": "test_shim", "rc": shim.returncode,
              "wall_s": shim_s, "markers": markers,
              "stdout": shim.stdout.strip().splitlines()[-1:],
              "nvidia_smi": smi})
        if shim.returncode != 0 or len(markers) != 4:
            raise AssertionError(f"test_shim rc {shim.returncode}\n"
                                 f"{shim.stdout}{shim.stderr[-3000:]}")

        path = os.path.join(d, "best_case.scene")
        scene.write_scene(path, RATE, True, tone_pool(N_TONES),
                          np.arange(N_VOICES) % N_TONES,
                          best_case_voices(N_VOICES), None, frames, 2)
        c_run = scene.run_scene_client(path, CARD)

    dev, py_build_s = wall(lambda: api_open_loopback(N_VOICES, CARD))
    (ctx, sids), scene_s = wall(lambda: api_scene(dev, N_VOICES))
    py_build_s += scene_s
    py_warm, py_warm_s = wall(lambda: al.alcRenderSamplesSOFT(dev, frames))
    py_out, py_s = wall(lambda: al.alcRenderSamplesSOFT(dev, frames))
    want = np.concatenate([py_warm, py_out])
    del dev, ctx, py_warm, py_out

    os.environ["OPENAL_TORCH_DEVICE"] = CARD       # the C ABI's device
    lib = ct.CDLL(str(native.build_shim()))
    cdev, ct_build_s = wall(lambda: cabi_scene(lib, N_VOICES))
    ct_warm = cabi_render(lib, cdev, frames)
    reset_counts(wrappers)
    ct_out, ct_s = wall(lambda: cabi_render(lib, cdev, frames))
    launches = counts(wrappers)
    lib.alcCloseDevice(cdev)
    got = np.concatenate([ct_warm, ct_out])
    del ct_warm, ct_out

    diff_c = float(np.abs(c_run["frames"] - want).max())
    diff_ct = float(np.abs(got - want).max())
    lim = LoopbackDevice(RATE, "stereo", "int16", capacity=16, device=CARD)
    native_limiter = (lim.limiter is not None
                      and getattr(lim.limiter, "_lib", None) is not None)
    lim_out = lim.render_samples(4096)
    secs = frames / RATE
    emit({"phase": "c_abi", "scene": "best_case", "voices": N_VOICES,
          "frames": frames, "library_build_s": NATIVE_BUILD["seconds"],
          "build_s": {"c": c_run["build_s"], "ctypes": ct_build_s,
                      "python": py_build_s},
          "render_s": {"c": c_run["render_s"],
                       "ctypes": ct_s, "python": [py_warm_s, py_s]},
          "x_realtime": {"c": secs / c_run["render_s"][-1],
                         "ctypes": secs / ct_s, "python": secs / py_s},
          "client_wall_s": c_run["wall_s"],
          "max_abs_diff_vs_python": {"c": diff_c, "ctypes": diff_ct},
          "launches": launches, "native_limiter": native_limiter,
          "peak": float(np.abs(want).max()), "nvidia_smi": smi})
    if diff_c != 0.0 or diff_ct != 0.0:
        raise AssertionError(f"the C ABI's best_case differs from al.api's: "
                             f"scene_client {diff_c}, ctypes {diff_ct}")
    if launches["resample_unit"] <= 0:
        raise AssertionError(f"the C ABI's best_case skipped resample_unit: "
                             f"{launches}")
    if not (native_limiter and lim_out.dtype == np.int16):
        raise AssertionError("the int16 output's limiter is not the native "
                             "library")


EXAMPLES = ("altonegen", "alhrtf", "alplay", "aldirect", "alconvolve",
            "aldebug", "allafplay", "allatency", "alloopback",
            "almultireverb", "alrecord", "alreverb", "alstream",
            "alstreamcb")


def example_args(name: str, d: str, seconds: float) -> tuple[list, str]:
    """The command line of one example at ``seconds`` of audio, inputs in
    ``d`` (written by example_inputs); and the WAV it writes, or ""."""
    out = os.path.join(d, f"{name}.wav")
    s = str(seconds)
    args = {"altonegen": ["-s", s, "-o", out], "alhrtf": ["-s", s, "-o", out],
            "alplay": [os.path.join(d, "in.wav"), "-o", out],
            "aldirect": ["--name", "Null Output"],
            "alconvolve": ["-s", s, "-o", out], "aldebug": [],
            "allafplay": [os.path.join(d, "in.laf"), "-o", out],
            "allatency": ["--seconds", s],
            "alloopback": ["-s", s, "-o", out],
            "almultireverb": ["--seconds", s, "-o", out],
            "alrecord": ["-s", s, "-o", out],
            "alreverb": ["-s", s, "-o", out],
            "alstream": [os.path.join(d, "in.wav"), "-o", out],
            "alstreamcb": ["--seconds", s, "-o", out]}[name]
    return args + ["--device", CARD], out if "-o" in args else ""


def example_inputs(d: str, seconds: float, seed: int) -> None:
    """A seeded stereo WAV (a tone and noise) and a three-track LAF file
    (left, right, LFE) of ``seconds`` each."""
    from openal_soft_tpu_torch.examples.allafplay import write_laf
    from openal_soft_tpu_torch.examples.altonegen import _write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * RATE)) / RATE
    _write_wav(os.path.join(d, "in.wav"), np.stack(
        [0.3 * np.sin(2 * np.pi * 330 * t),
         0.2 * rng.standard_normal(t.size)], 1).astype(np.float32), RATE)
    write_laf(os.path.join(d, "in.laf"),
              (0.2 * rng.standard_normal((3, t.size))).astype(np.float32),
              RATE, [(0.0, 30.0, 0), (0.0, -30.0, 0), (0.0, 0.0, 1)])


def wav_peak(path: str) -> float:
    import wave

    with wave.open(path, "rb") as fh:
        pcm = np.frombuffer(fh.readframes(fh.getnframes()), "<i2")
    return float(np.abs(pcm.astype(np.float32)).max() / 32768.0)


def phase_examples(wrappers: dict, smi: str) -> None:
    """Phase 33: each of the 14 examples' main() on the card with <= 2 s of
    audio and seeded inputs; every WAV written is nonzero; alreverb and
    almultireverb launch the reverb kernel."""
    import contextlib as cl
    import importlib
    import io

    with tempfile.TemporaryDirectory() as d:
        example_inputs(d, EXAMPLE_SECONDS, 33)
        for name in EXAMPLES:
            mod = importlib.import_module(
                f"openal_soft_tpu_torch.examples.{name}")
            args, out = example_args(name, d, EXAMPLE_SECONDS)
            text = io.StringIO()
            reset_counts(wrappers)
            with cl.redirect_stdout(text):
                _, sec = wall(lambda: mod.main(args))
            launches = counts(wrappers)
            peak = wav_peak(out) if out else None
            emit({"phase": "examples", "example": name, "wall_s": sec,
                  "wav_peak": peak,
                  "launches": {k: v for k, v in launches.items() if v},
                  "last_line": text.getvalue().strip().splitlines()[-1:],
                  "nvidia_smi": smi})
            if out and not peak > 0.0:
                raise AssertionError(f"{name} wrote a silent {out}")
            if name in ("alreverb", "almultireverb") \
                    and launches["reverb"] <= 0:
                raise AssertionError(f"{name} skipped reverb: {launches}")


# --- the voice-sharded block graph (phase 34) ---------------------------------

SHARD_BLOCKS = 8
SHARD_TOL = 1e-5           # x max(1, peak): float32 reassociation of 4 sums
SHARD_KERNELS = ("resample_gen", "reverb", "biquad")
SHARD_STATE = ("filter_z", "hrtf_history", "hrtf_tail")
SHARD_TIMEOUT = 300.0      # each rank's collectives and the parent's wait


def sharded_scene(device: str):
    """The loaded scene at full width plus one UHJ2 bed: N_VOICES voices
    at capacity N_VOICES + 4, the bed on rows 2049-2051, across the
    boundary of two 2050-row shards."""
    cap = N_VOICES + 4
    return bench_scene(N_VOICES, cap, device, loaded=True,
                       uhj_at=cap // 2 - 1)


def shard_rank(rank: int, world: int, group, unsharded: bool) -> dict:
    """One rank of phase 34: SHARD_BLOCKS carried 1024-frame blocks of
    sharded_scene through the sharded step (its wall ms each, the card
    synchronised, and the launches of K3, K6 and K7 from 0), the carried
    per-voice state gathered back; with ``unsharded`` also the same blocks
    through the unsharded graph on the same inputs."""
    import torch

    from openal_soft_tpu_torch.ops.kernels import biquad as biq
    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen
    from openal_soft_tpu_torch.ops.kernels import reverb as rev_k
    from openal_soft_tpu_torch.parallel import sharding as sh

    wrappers = {"resample_gen": rs_gen.resample_gen,
                "reverb": rev_k.reverb_pipeline, "biquad": biq.biquad_dual}
    dev = sharded_scene("cuda")
    state, ev, cfg, pool = sh.device_step_inputs(dev, BLOCK)
    step = sh.make_sharded_device_step(dev, group, BLOCK)
    any_fade = step.any_fade

    def blocks(render) -> tuple[np.ndarray, list]:
        outs, ms = [], []
        for b in range(SHARD_BLOCKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(render(b))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return torch.cat(outs, dim=1).cpu().numpy(), ms

    st, e, c = sh.shard_inputs(state, ev, cfg, rank, world)
    carried = [st, e]

    def sharded(b):
        out, carried[0], carried[1] = step(carried[0], carried[1], c, pool)
        return out

    for w in wrappers.values():
        w.launches = 0
    out, ms = blocks(sharded)
    launches = {k: w.launches for k, w in wrappers.items()}
    st = sh.gather_voices(carried[0], group)
    e = sh.gather_voices(carried[1], group)
    res = {"out": out, "ms": ms, "launches": launches,
           "shard_rows": int(c["active"].shape[0]),
           "uhj_rows": [r for v in dev._uhj_groups["u2"] for r in v.rows],
           "state": {k: st[k].cpu().numpy() for k in SHARD_STATE},
           "pos_int": e["pos_int"].cpu().numpy()}
    if unsharded:
        st1, e1 = sh._clone(state), sh._clone(ev)
        ref, ref_ms = blocks(lambda b: dev._render_one(
            st1, e1, cfg, pool, BLOCK, step.kind, any_fade and b == 0,
            step.gates))
        res.update(ref=ref, ref_ms=ref_ms,
                   ref_state={k: st1[k].cpu().numpy() for k in SHARD_STATE},
                   ref_pos_int=e1["pos_int"].cpu().numpy())
    return res


def phase_sharding(smi: str) -> None:
    """Phase 34: the voice-sharded graph (parallel/sharding.py) on the
    card.  (a) world 1 over NCCL in a spawned process: bit-equal to the
    unsharded graph over SHARD_BLOCKS carried blocks.  (b) world 2 over
    gloo on CUDA tensors, two processes on the one card: within
    SHARD_TOL x max(1, peak) of (a)'s unsharded render, K3, K6 and K7
    launched on each rank.  (c) wall ms per block: median of blocks 1-7
    (block 0 fades in).  (d) ``dryrun_multichip(1)``, the module's dry
    run at its defaults (NCCL, the card)."""
    from openal_soft_tpu_torch.parallel import sharding as sh

    t0 = time.perf_counter()
    a = sh.run_ranks(1, shard_rank, (True,), backend="nccl", device="cuda",
                     timeout=SHARD_TIMEOUT)[0]
    a_s = time.perf_counter() - t0
    same = {"out": bool(np.array_equal(a["out"], a["ref"])),
            "pos_int": bool(np.array_equal(a["pos_int"], a["ref_pos_int"]))}
    same.update({k: bool(np.array_equal(a["state"][k], a["ref_state"][k]))
                 for k in SHARD_STATE})
    ref, peak = a["ref"], float(np.abs(a["ref"]).max())
    emit({"phase": "sharding", "case": "world 1, nccl", "voices": N_VOICES,
          "shard_rows": a["shard_rows"], "uhj_rows": a["uhj_rows"],
          "blocks": SHARD_BLOCKS, "frames": BLOCK, "bit_equal": same,
          "peak": peak, "launches": a["launches"],
          "sharded_ms_per_block": float(np.median(a["ms"][1:])),
          "unsharded_ms_per_block": float(np.median(a["ref_ms"][1:])),
          "sharded_ms": a["ms"], "unsharded_ms": a["ref_ms"],
          "wall_s": a_s, "nvidia_smi": smi})
    if not all(same.values()):
        raise AssertionError(f"world 1 is not bit-equal to the unsharded "
                             f"graph: {same}")
    if not (np.isfinite(ref).all() and peak > 0.0
            and ref.shape == (2, SHARD_BLOCKS * BLOCK)):
        raise AssertionError(f"phase 34's render is not finite, nonzero "
                             f"[2, {SHARD_BLOCKS * BLOCK}]: {ref.shape}")
    t0 = time.perf_counter()
    b = sh.run_ranks(2, shard_rank, (False,), backend="gloo", device="cuda",
                     timeout=SHARD_TIMEOUT)
    b_s = time.perf_counter() - t0
    err = float(np.abs(b[0]["out"] - ref).max())
    state_err = {k: float(np.abs(b[0]["state"][k]
                                 - a["ref_state"][k]).max())
                 for k in SHARD_STATE}
    tol = SHARD_TOL * max(1.0, peak)
    emit({"phase": "sharding", "case": "world 2, gloo on one card",
          "shard_rows": [r["shard_rows"] for r in b],
          "uhj_rows": b[0]["uhj_rows"], "max_abs_err": err, "peak": peak,
          "tol": tol, "state_max_abs_err": state_err,
          "pos_int_equal": bool(np.array_equal(b[0]["pos_int"],
                                               a["ref_pos_int"])),
          "ranks_equal": bool(np.array_equal(b[0]["out"], b[1]["out"])),
          "launches": [r["launches"] for r in b],
          "ms_per_block": [float(np.median(r["ms"][1:])) for r in b],
          "ms": [r["ms"] for r in b], "wall_s": b_s, "nvidia_smi": smi})
    if not (np.isfinite(b[0]["out"]).all() and err <= tol):
        raise AssertionError(f"world 2 deviates from the unsharded graph "
                             f"by {err} (tol {tol})")
    if not np.array_equal(b[0]["out"], b[1]["out"]):
        raise AssertionError("world 2's ranks render different outputs")
    if not np.array_equal(b[0]["pos_int"], a["ref_pos_int"]):
        raise AssertionError("world 2's voice positions differ")
    for rank, r in enumerate(b):
        if not all(r["launches"][k] > 0 for k in SHARD_KERNELS):
            raise AssertionError(f"rank {rank} skipped a kernel: "
                                 f"{r['launches']}")
    # (d) the module's dry run at its defaults: one rank over NCCL.
    t0 = time.perf_counter()
    dry = sh.dryrun_multichip(1)
    emit({"phase": "sharding", "case": "dryrun_multichip(1)", **dry,
          "wall_s": time.perf_counter() - t0, "nvidia_smi": smi})


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it): the bytes over the HBM rate against the
    operations over the fp32 peak, whichever takes longer."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def resample_bound(V: int, W: int, taps: int, pool_len: int,
                   meta_cols: int, bank_floats: int) -> tuple[float, str]:
    """A resampler call: the output written once and every input read
    once, against ~8 flops per tap (weight, product, sum)."""
    return bound(4 * (V * W + pool_len + V * meta_cols + bank_floats),
                 8 * taps * V * W)


def reverb_bound(eff, W: int) -> tuple[float, str]:
    """One pipeline window: ain read, early/late written, the main line
    written, and each ring's touched slots read and written once; against
    ~(120 + 4*e_passes + 9*l_passes) flops per line-sample (the stages in
    csrc/reverb.cu).  Neither counts the chunk loop's latency."""
    rings = (eff.len_late_in, eff.len_early_ap, eff.len_early, eff.len_vecap,
             eff.len_late)
    return bound(4 * 4 * (W + 2 * W + W + sum(2 * min(L, W) for L in rings)),
                 4 * W * (120 + 4 * eff.early_ap_passes
                          + 9 * eff.late_ap_passes))


def profile(scene: str, smi: str, seed: int = 0) -> None:
    """``--profile <scene>``: the scene at full width, one warm
    512-block call, then torch.profiler over one more.  Prints the device
    time by kernel and by aten op and input shape."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    build_all()
    if scene == "speakers_filtered":
        dev = bench_scene(N_VOICES, N_VOICES, "cuda", loaded=True,
                          filtered=True, hrtf=False)
    elif scene == "uhj_big_pool":
        dev, _ = uhj_pool_scene("cuda", N_VOICES, 1024, 4 * RATE, 16, 8,
                                20 * RATE)
    elif scene == "fx_rack":
        dev = fx_rack_scene(N_VOICES, "cuda", seed)
    else:
        dev = bench_scene(N_VOICES, N_VOICES, "cuda",
                          loaded=scene == "loaded")
    frames = CHUNK_BLOCKS * BLOCK
    dev.render_samples(frames)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.render_samples(frames)
    wall_plain = time.perf_counter() - t0
    # fx_rack issues ~3600 device operations per block: a 512-block trace
    # takes the profiler longer to summarise than the run, so it records
    # 16 blocks.
    profiled = 16 * BLOCK if scene == "fx_rack" else frames
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        t0 = time.perf_counter()
        dev.render_samples(profiled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dtime = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=dtime, reverse=True)
    busy_ms = sum(dtime(e) for e in kernels) / 1e3
    emit({"phase": "profile", "scene": scene, "voices": N_VOICES,
          "frames": profiled, "wall_ms": 1e3 * wall,
          "frames_unprofiled": frames,
          "wall_ms_unprofiled": 1e3 * wall_plain,
          "x_realtime_unprofiled": (frames / RATE) / wall_plain,
          "device_busy_ms": busy_ms,
          "idle_share": max(0.0, 1.0 - busy_ms / (1e3 * wall)),
          "idle_share_unprofiled": max(0.0, 1.0 - busy_ms * frames / profiled
                                       / (1e3 * wall_plain)),
          "nvidia_smi": smi})
    for e in kernels[:25]:
        emit({"phase": "profile", "kernel": e.key[:120], "calls": e.count,
              "device_ms": dtime(e) / 1e3})
    total = lambda e: getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0.0)
    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type == DeviceType.CPU and total(e) > 0
                  and e.key.startswith("aten::")), key=total, reverse=True)
    for e in ops[:30]:
        emit({"phase": "profile", "op": e.key, "shapes": str(e.input_shapes)
              [:160], "calls": e.count, "device_ms_total": total(e) / 1e3})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    seed = (int(sys.argv[sys.argv.index("--seed") + 1])
            if "--seed" in sys.argv else 0)
    if sys.argv[1:2] == ["--profile"]:
        profile(sys.argv[2], nvidia_smi(), seed)
        return 0
    from openal_soft_tpu_torch.ops.kernels import biquad as biq
    from openal_soft_tpu_torch.ops.kernels import resample_gen as rs_gen
    from openal_soft_tpu_torch.ops.kernels import resample_span as rs_span
    from openal_soft_tpu_torch.ops.kernels import resample_unit as rs_unit
    from openal_soft_tpu_torch.ops.kernels import resample_voice as rs_voice
    from openal_soft_tpu_torch.ops.kernels import reverb as rev_k

    cuda = torch.device("cuda", 0)
    smi = nvidia_smi()
    wrappers = {"resample_unit": rs_unit.resample_unit,
                "resample_gen": rs_gen.resample_gen,
                "reverb": rev_k.reverb_pipeline,
                "biquad": biq.biquad_dual}
    wrappers["resample_span"] = rs_span.resample_span
    wrappers["resample_voice"] = rs_voice.resample_voice
    wrappers["effect_scan"] = EffectScanCount()
    report = {name: {"name": name, "route": "cuda",
                     "source": f"openal_soft_tpu_torch/csrc/{name}.cu",
                     "replaces": REPLACES[name], "library_ms": None}
              for name in KERNELS}

    # 1. environment
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build
    build_all()

    # 3. the unit kernel against its plain version on the card
    report["resample_unit"]["max_abs_err"] = check_unit_kernel(cuda)

    # 4. timing at the main path's shape: V=4096, W=16*1024, taps=4, on
    # best_case-like voices (48 looping one-second tones), then at one
    # block (W=1024)
    pool = np.concatenate([np.zeros(8, np.float32), *tone_pool(N_TONES),
                           np.zeros(4096, np.float32)])
    phase_unit_timings(cuda, report, smi, pool)

    # 5. best_case at full width through the port's entry points
    t0 = time.perf_counter()
    dev = bench_scene(N_VOICES, N_VOICES, "cuda")
    setup_s = time.perf_counter() - t0
    frames = CHUNK_BLOCKS * BLOCK
    t0 = time.perf_counter()
    dev.render_samples(frames)                       # warm
    warm_s = time.perf_counter() - t0
    rs_unit.resample_unit.launches = 0
    t0 = time.perf_counter()
    out = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    report["resample_unit"]["launches"] = rs_unit.resample_unit.launches
    finite = bool(np.isfinite(out).all())
    peak = float(np.abs(out).max())
    emit({"phase": "best_case", "voices": N_VOICES, "frames": frames,
          "setup_s": setup_s, "warm_s": warm_s, "render_s": dt,
          "x_realtime": (frames / RATE) / dt,
          "launches": rs_unit.resample_unit.launches, "finite": finite,
          "peak": peak, "shape": list(out.shape), "nvidia_smi": smi})
    if out.shape != (frames, 2) or not finite or not peak > 0.0:
        raise AssertionError("best_case output is not finite, nonzero "
                             f"[{frames}, 2]: shape {out.shape}, "
                             f"finite {finite}, peak {peak}")
    if rs_unit.resample_unit.launches <= 0:
        raise AssertionError("best_case never launched resample_unit")
    del dev, out

    # 6. best_case on the card against the port on the CPU
    g = bench_scene(64, 64, "cuda")
    c = bench_scene(64, 64, "cpu")
    for n, path in ((8192, "fused"), (4096, "per-block"), (100, "odd"),
                    (924, "odd"), (1, "odd")):
        a, b = g.render_samples(n), c.render_samples(n)
        err = float(np.abs(a - b).max())
        emit({"phase": "parity", "scene": "best_case", "frames": n,
              "path": path, "max_abs_err": err, "tol": PARITY_TOL})
        if not (np.isfinite(a).all() and err <= PARITY_TOL):
            raise AssertionError(f"GPU vs CPU port at {n} frames: {err}")

    # 7-8. the general resampler and the reverb against their plain versions
    report["resample_gen"]["max_abs_err"] = check_gen_kernel(cuda)
    report["reverb"]["max_abs_err"] = check_reverb_kernel(cuda)

    # 9. timing at the loaded scene's shapes: 4096 voices on the 48
    # looping tones at pitch 2**U(-1,1), W = 16*1024, taps = 4
    from openal_soft_tpu_torch.ops import tables

    rng = np.random.default_rng(3)
    W, taps, lens = 16 * BLOCK, 4, np.full(N_VOICES, RATE)
    Ti = lambda a: torch.tensor(np.asarray(a), device=cuda).to(torch.int32)
    bank = {k: torch.tensor(v, device=cuda)
            for k, v in tables.weight_bank().items()}
    gargs = (torch.tensor(pool, device=cuda),
             Ti(8 + (np.arange(N_VOICES) % N_TONES) * RATE), Ti(lens),
             Ti(np.zeros(N_VOICES)), Ti(lens),
             torch.ones(N_VOICES, dtype=torch.bool, device=cuda),
             torch.tensor(rng.random(N_VOICES) < 0.5, device=cuda),
             Ti(rng.integers(0, RATE, N_VOICES)),
             Ti(rng.integers(0, 1 << 16, N_VOICES)),
             Ti(np.floor(2.0 ** rng.uniform(-1, 1, N_VOICES) * 65536)),
             Ti(np.zeros(N_VOICES)),
             torch.tensor(rng.random(N_VOICES).astype(np.float32),
                          device=cuda), bank)
    gsl = rs_gen.slice_bank(bank, taps)
    max_inc = int(gargs[9].max())
    want = rs_gen.resample_gen_ref(*gargs, W, taps)
    got = rs_gen.resample_gen(*gargs, W, taps, bank_sl=gsl, max_inc=max_inc)
    if not torch.equal(got, want):
        raise AssertionError("resample_gen != plain at the loaded shape")
    del got
    times = time_window_kernel("resample_gen", gargs, W, taps, gsl, max_inc,
                               want)
    wrapper_ms = cuda_ms(lambda: rs_gen.resample_gen(
        *gargs, W, taps, bank_sl=gsl, max_inc=max_inc), 20, 3)
    plain_ms = cuda_ms(lambda: rs_gen.resample_gen_ref(*gargs, W, taps),
                       5, 1)
    bound_ms, bound_by = resample_bound(N_VOICES, W, taps, pool.size, 12,
                                        gsl.numel() + N_VOICES)
    report["resample_gen"].update(ms=times["ms"], plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
    emit(rates({"phase": "timing", "name": "resample_gen", "V": N_VOICES,
                "W": W, "taps": taps, "max_inc": max_inc,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "nvidia_smi": smi},
               {**times, "wrapper_ms": wrapper_ms}, 4 * N_VOICES * W,
               bound_ms))
    del gargs, gsl, want
    phase_reverb_timings(cuda, report, smi)

    # 10. loaded at full width through the port's entry points
    t0 = time.perf_counter()
    dev = bench_scene(N_VOICES, N_VOICES, "cuda", loaded=True)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev.render_samples(frames)                       # warm
    warm_s = time.perf_counter() - t0
    for name in KERNELS:
        wrappers[name].launches = 0
    t0 = time.perf_counter()
    out = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in KERNELS}
    for name in ("resample_gen", "reverb"):
        report[name]["launches"] = launches[name]
    finite = bool(np.isfinite(out).all())
    peak = float(np.abs(out).max())
    emit({"phase": "loaded", "voices": N_VOICES, "frames": frames,
          "setup_s": setup_s, "warm_s": warm_s, "render_s": dt,
          "x_realtime": (frames / RATE) / dt, "launches": launches,
          "finite": finite, "peak": peak, "shape": list(out.shape),
          "nvidia_smi": smi})
    if out.shape != (frames, 2) or not finite or not peak > 0.0:
        raise AssertionError("loaded output is not finite, nonzero "
                             f"[{frames}, 2]: shape {out.shape}, "
                             f"finite {finite}, peak {peak}")
    if not (launches["resample_gen"] > 0 and launches["reverb"] > 0):
        raise AssertionError(f"loaded skipped a kernel: {launches}")
    del dev, out

    # 11. loaded on the card against the port on the CPU
    g = bench_scene(64, 64, "cuda", loaded=True)
    c = bench_scene(64, 64, "cpu", loaded=True)
    for n, path in ((8192, "fused"), (4096, "per-block"), (100, "odd"),
                    (924, "odd")):
        a, b = g.render_samples(n), c.render_samples(n)
        err = float(np.abs(a - b).max())
        emit({"phase": "parity", "scene": "loaded", "frames": n,
              "path": path, "max_abs_err": err, "tol": LOADED_TOL,
              "peak": float(np.abs(b).max())})
        if not (np.isfinite(a).all() and err <= LOADED_TOL):
            raise AssertionError(f"loaded GPU vs CPU port at {n} frames: "
                                 f"{err}")

    # 12-13. the biquad kernel against its plain version, then timed at the
    # main path's shapes
    report["biquad"]["max_abs_err"] = check_biquad_kernel(cuda)
    phase_biquad_timings(cuda, report, smi)

    # 14. speakers_filtered at full width through the port's entry points
    t0 = time.perf_counter()
    dev = bench_scene(N_VOICES, N_VOICES, "cuda", loaded=True,
                      filtered=True, hrtf=False)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev.render_samples(frames)                       # warm
    warm_s = time.perf_counter() - t0
    refilter(dev, np.random.default_rng(7))   # the next block interpolates
    for name in KERNELS:
        wrappers[name].launches = 0
    t0 = time.perf_counter()
    out = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in KERNELS}
    report["biquad"]["launches"] = launches["biquad"]
    t0 = time.perf_counter()
    out2 = dev.render_samples(frames)
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0
    finite = bool(np.isfinite(out).all() and np.isfinite(out2).all())
    peak = float(min(np.abs(out).max(), np.abs(out2).max()))
    emit({"phase": "speakers_filtered", "voices": N_VOICES, "frames": frames,
          "setup_s": setup_s, "warm_s": warm_s, "render_s": [dt, dt2],
          "x_realtime": [(frames / RATE) / dt, (frames / RATE) / dt2],
          "launches": launches, "finite": finite, "peak": peak,
          "shape": list(out.shape), "nvidia_smi": smi})
    if out.shape != (frames, 2) or not finite or not peak > 0.0:
        raise AssertionError("speakers_filtered output is not finite, "
                             f"nonzero [{frames}, 2]: shape {out.shape}, "
                             f"finite {finite}, peak {peak}")
    if not all(launches[k] > 0 for k in ("resample_gen", "reverb",
                                         "biquad")):
        raise AssertionError(f"speakers_filtered skipped a kernel: "
                             f"{launches}")
    del dev, out, out2

    # 15. the filtered scenes on the card against the port on the CPU
    for name in SPEAKER_SCENES:
        g = speaker_scene(name, 64, "cuda")
        c = speaker_scene(name, 64, "cpu")
        before = biq.biquad_dual.launches
        for n, path in ((8192, "multi-block"), (4096, "per-block"),
                        (100, "odd"), (924, "odd")):
            a, b = g.render_samples(n), c.render_samples(n)
            err = float(np.abs(a - b).max())
            emit({"phase": "parity", "scene": name, "frames": n,
                  "path": path, "channels": int(b.shape[1]),
                  "max_abs_err": err, "tol": SPEAKERS_TOL,
                  "peak": float(np.abs(b).max())})
            if not (np.isfinite(a).all() and err <= SPEAKERS_TOL):
                raise AssertionError(f"{name} GPU vs CPU port at {n} "
                                     f"frames: {err}")
        if biq.biquad_dual.launches <= before:
            raise AssertionError(f"{name} never launched biquad")

    # 16-17. the span and per-voice resamplers against their plain versions
    one = 1 << 16
    report["resample_span"]["max_abs_err"] = check_resample_kernel(
        cuda, "resample_span", rs_span.resample_span,
        rs_span.resample_span_ref,
        [(256, W, taps, (one // 4, 10 * one)) for taps in (1, 2, 4, 24, 48)
         for W in (128, 1024, 1152, 16512, 16640)] + WINDOW_CASES)
    report["resample_voice"]["max_abs_err"] = check_resample_kernel(
        cuda, "resample_voice", rs_voice.resample_voice,
        rs_voice.resample_voice_ref,
        [(256, W, taps, incs) for taps in (1, 4, 48)
         for W, incs in ((128, (one // 4, 10 * one)),
                         (1024, (one // 4, 10 * one)),
                         (1152, (one // 4, 9 * one)),
                         (16512, (one // 4, 42000)))] + VOICE_CASES)
    phase_timings(cuda, report, smi)

    # 19-20. uhj_big_pool at full width, then the UHJ parity scenes
    phase_uhj_big_pool(wrappers, report, smi)
    phase_uhj_parity(wrappers)

    # 21-23. effect_scan against its plain version, the biquad kernel in
    # the effects' shapes, then effect_scan timed
    report["effect_scan"]["max_abs_err"] = check_effect_scan(cuda)
    report["biquad"]["max_abs_err"] = max(report["biquad"]["max_abs_err"],
                                          check_biquad_effect_shapes(cuda))
    phase_effect_scan_timings(cuda, report, smi)

    # 24-25. fx_rack at full width, then every engine on the card against
    # the port on the CPU
    phase_fx_rack(wrappers, report, smi, seed)
    phase_fx_parity(wrappers, seed)

    # 26-28. the AL/ALC entry points, EAX and the playback lifecycle
    plain = phase_api(wrappers, smi)
    phase_eax(wrappers, smi, plain)
    del plain
    phase_playback(wrappers, smi)

    # 29-33. the offline tools, the C ABI and the examples
    phase_uhj_tools(wrappers, smi)
    phase_makemhr(wrappers, smi)
    phase_openal_info(smi)
    phase_c_abi(wrappers, smi)
    phase_examples(wrappers, smi)

    # 34. the voice-sharded graph: world 1 over NCCL, world 2 over gloo
    phase_sharding(smi)

    reference = [m for m in sys.modules if m in ("jax", "openal_soft_tpu")
                 or m.startswith(("jax.", "openal_soft_tpu."))]
    if reference:
        raise AssertionError(f"the port imported the JAX package or JAX: "
                             f"{reference[:3]}")

    emit({"kernels": [report[name] for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
