"""The port's AL/ALC entry points (openal_soft_tpu_torch.al.api) against
the JAX package's, call for call, on the CPU.

Renders without slots or filters agree within 1e-5 (the repo's bound for
the two packages' rounding); host state (getter values, AL error codes,
extension strings, debug messages and events) is compared exactly.  The
port's API-built scenes are bit-equal to its directly built ones.  The
scenes reuse ``tests/test_al_api.py``'s device (44.1 kHz, capacity 8), so
the JAX renders share its compiled graphs.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from openal_soft_tpu.al import api as jax_api
from openal_soft_tpu_torch.al import api as port_api
from openal_soft_tpu_torch.al import debug as dbg

RATE = 44100
TOL = 1e-5
APIS = {"jax": jax_api, "port": port_api}
DEVICE_KW = {jax_api: {}, port_api: {"device": "cpu"}}


@pytest.fixture(scope="module", autouse=True)
def jax_renders_from_private_copies():
    """The JAX device uploads its host ParamTable with ``jnp.asarray``,
    which on XLA:CPU aliases the numpy arrays without a copy, and then
    advances the table in place (``finish_chunk``) while the dispatched
    render may still read them. Under load a render after a host change
    (a play, a pause, a stop) sometimes sees the advanced table and skips
    its fade (ROADMAP C10). Here the JAX device uploads private copies;
    what it computes is unchanged.  Module-scoped, so that it also covers
    the renders of a module's module-scoped fixtures (pytest sets those
    up before any function-scoped fixture)."""
    from openal_soft_tpu.core.device import ParamTable, RenderDevice

    def on_copies(method, fields, table_of):
        def upload(self):
            table = table_of(self)
            live = {k: getattr(table, k) for k in fields}
            for k, v in live.items():
                setattr(table, k, v.copy())
            try:
                return method(self)
            finally:
                for k, v in live.items():
                    setattr(table, k, v)
        return upload

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ParamTable, "evolving_dict", on_copies(
            ParamTable.evolving_dict, ParamTable._EVOLVING, lambda t: t))
        mp.setattr(RenderDevice, "_cfg_from_table", on_copies(
            RenderDevice._cfg_from_table, ParamTable._CONFIG,
            lambda dev: dev.table))
        yield


def _open(api):
    """tests/test_al_api.py's device: 44.1 kHz stereo, capacity 8."""
    return api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                         capacity=8, **DEVICE_KW[api])


def _tone_scene(api, dev):
    """tests/test_al_api.py's first scene on ``dev``: a looping int16
    tone, not yet playing."""
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)
    buf = api.alGenBuffers()
    t = np.arange(22050) / RATE
    tone = (0.4 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    api.alBufferData(buf, api.AL_FORMAT_MONO16, tone, RATE)
    src = api.alGenSources()
    api.alSourcei(src, api.AL_BUFFER, buf)
    api.alSourcei(src, api.AL_LOOPING, api.AL_TRUE)
    api.alSourcef(src, api.AL_GAIN, 0.8)
    api.alSource3f(src, api.AL_POSITION, 1.0, 0.0, -1.0)
    api.alListenerfv(api.AL_ORIENTATION, [0, 0, -1, 0, 1, 0])
    api.alDistanceModel(api.AL_INVERSE_DISTANCE_CLAMPED)
    return ctx, buf, src


def _source_state(api, dev, buf, src):
    """Every getter this scene answers, in one list."""
    return [
        api.alGetSourcei(src, api.AL_SOURCE_STATE),
        api.alGetSourcei(src, api.AL_SAMPLE_OFFSET),
        api.alGetSourcei(src, api.AL_BYTE_OFFSET),
        api.alGetSourcei(src, api.AL_BUFFERS_QUEUED),
        api.alGetSourcei(src, api.AL_BUFFERS_PROCESSED),
        api.alGetSourcei(src, api.AL_SOURCE_TYPE),
        api.alGetSourcef(src, api.AL_SEC_OFFSET),
        api.alGetSourcef(src, api.AL_GAIN),
        api.alGetSource3f(src, api.AL_POSITION),
        api.alGetSourceiv(src, api.AL_POSITION),
        api.alGetSourcei64vSOFT(src, api.AL_SAMPLE_OFFSET_LATENCY_SOFT),
        api.alGetSourcei64vSOFT(src, api.AL_SAMPLE_OFFSET_CLOCK_SOFT),
        api.alGetSourcedvSOFT(src, api.AL_SEC_OFFSET_LATENCY_SOFT),
        api.alGetSourcedvSOFT(src, api.AL_SEC_OFFSET_CLOCK_SOFT),
        api.alGetListenerfv(api.AL_ORIENTATION),
        api.alGetInteger(api.AL_DISTANCE_MODEL),
        [api.alGetBufferi(buf, p) for p in (api.AL_FREQUENCY, api.AL_BITS,
                                            api.AL_CHANNELS, api.AL_SIZE)],
        api.alGetBufferf(buf, api.AL_SEC_LENGTH_SOFT),
        api.alcGetIntegerv(dev, api.ALC_ALL_ATTRIBUTES),
        api.alcGetInteger64vSOFT(dev, api.ALC_DEVICE_CLOCK_SOFT),
        api.alcGetInteger64vSOFT(dev, api.ALC_DEVICE_CLOCK_LATENCY_SOFT),
        api.alGetError(),
    ]


def test_tone_scene_renders_and_answers_as_jax():
    """Play, render (whole blocks, then an odd size that leaves a carry),
    pause, resume and stop through both APIs: renders within 1e-5, every
    getter equal after each step."""
    out = {}
    for name, api in APIS.items():
        dev = _open(api)
        ctx, buf, src = _tone_scene(api, dev)
        steps = [_source_state(api, dev, buf, src)]
        api.alSourcePlay(src)
        renders = [api.alcRenderSamplesSOFT(dev, 2048)]
        steps.append(_source_state(api, dev, buf, src))
        api.alSourcePause(src)
        renders.append(api.alcRenderSamplesSOFT(dev, 2048))
        steps.append(_source_state(api, dev, buf, src))
        api.alSourcePlay(src)
        renders.append(api.alcRenderSamplesSOFT(dev, 2048))
        steps.append(_source_state(api, dev, buf, src))
        api.alSourceStop(src)
        renders.append(api.alcRenderSamplesSOFT(dev, 2048))
        steps.append(_source_state(api, dev, buf, src))
        out[name] = (renders, steps)
    for got, want in zip(out["port"][0], out["jax"][0]):
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= TOL
    assert np.abs(out["port"][0][0]).max() > 0.01
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1][1][0] == port_api.AL_PLAYING
    assert out["port"][1][-1][0] == port_api.AL_STOPPED


def test_streaming_queue_matches_jax():
    """tests/test_al_api.py's streaming loop: queue, unqueue, refill and
    requeue through both APIs."""
    out = {}
    for name, api in APIS.items():
        dev = _open(api)
        api.alcMakeContextCurrent(api.alcCreateContext(dev))
        n = 2048
        bufs = [api.alGenBuffers() for _ in range(3)]
        for i, b in enumerate(bufs):
            tone = (0.2 * np.sin(2 * np.pi * (220 + 110 * i)
                                 * np.arange(n) / RATE)).astype(np.float32)
            api.alBufferData(b, api.AL_FORMAT_MONO_FLOAT32, tone, RATE)
        src = api.alGenSources()
        api.alSourceQueueBuffers(src, bufs)
        res = [api.alGetSourcei(src, api.AL_BUFFERS_QUEUED)]
        api.alSourcePlay(src)
        renders = [api.alcRenderSamplesSOFT(dev, 2 * n + 256)]
        res += [api.alGetSourcei(src, api.AL_SOURCE_STATE),
                api.alGetSourcei(src, api.AL_BUFFERS_PROCESSED)]
        got = [api.alSourceUnqueueBuffers(src, 1) for _ in range(2)]
        res += got + [api.alGetSourcei(src, api.AL_BUFFERS_QUEUED)]
        for b in got:
            api.alSourceQueueBuffers(src, [b])
        renders.append(api.alcRenderSamplesSOFT(dev, 2 * n))
        res += [api.alGetSourcei(src, api.AL_BUFFERS_PROCESSED),
                api.alGetSourcei(src, api.AL_SAMPLE_OFFSET)]
        renders.append(api.alcRenderSamplesSOFT(dev, 2 * n))
        res += [api.alGetSourcei(src, api.AL_SOURCE_STATE), api.alGetError()]
        out[name] = (renders, res)
    for got, want in zip(out["port"][0], out["jax"][0]):
        assert float(np.abs(got - want).max()) <= TOL
    assert out["port"][1] == out["jax"][1]


def _host_calls(api):
    """A sequence of host-only calls: each entry's value (or the name of
    what it raised) and the AL error it left."""
    dev = _open(api)
    api.alcMakeContextCurrent(api.alcCreateContext(dev))
    # Ids come from one counter: sources 1 and 2, buffer 3, filter 4,
    # effect 5, slot 6.
    calls = [
        lambda: api.alGenSources(2),
        lambda: api.alGenBuffers(),
        lambda: api.alGenFilters(),
        lambda: api.alGenEffects(),
        lambda: api.alGenAuxiliaryEffectSlots(),
        lambda: api.alSourcePlay(9999),
        lambda: api.alSourcef(9999, api.AL_GAIN, 1.0),
        lambda: api.alSourcei(1, 0xDEAD, 1),
        lambda: api.alGetSourcei(12345, api.AL_SOURCE_STATE),
        lambda: api.alSource3i(1, api.AL_POSITION, 1, 2, 3),
        lambda: api.alSourcef(1, api.AL_PITCH, 1.5),
        lambda: api.alGetSourcef(1, api.AL_PITCH),
        lambda: api.alSourcei(1, api.AL_SOURCE_RELATIVE, 1),
        lambda: api.alSourcei(1, api.AL_SOURCE_SPATIALIZE_SOFT, 2),
        lambda: api.alSourcei(1, api.AL_SOURCE_RESAMPLER_SOFT, 4),
        lambda: api.alSourcefv(1, api.AL_VELOCITY, [1.0, 2.0, 3.0]),
        lambda: api.alGetSource3i(1, api.AL_VELOCITY),
        lambda: api.alGetSourcefv(1, api.AL_GAIN),
        lambda: api.alListener3f(api.AL_POSITION, 1.0, 2.0, 3.0),
        lambda: api.alListenerf(api.AL_GAIN, 0.5),
        lambda: api.alGetListenerf(api.AL_GAIN),
        lambda: api.alGetListener3i(api.AL_POSITION),
        lambda: api.alListeneri(api.AL_GAIN, 1),
        lambda: api.alDopplerVelocity(-1.0),
        lambda: api.alDistanceModel(api.AL_LINEAR_DISTANCE),
        lambda: api.alGetInteger(api.AL_DISTANCE_MODEL),
        lambda: api.alGetInteger(api.AL_NUM_RESAMPLERS_SOFT),
        lambda: api.alGetInteger(api.AL_DEFAULT_RESAMPLER_SOFT),
        lambda: [api.alGetStringiSOFT(api.AL_RESAMPLER_NAME_SOFT, i)
                 for i in range(api.alGetInteger(
                     api.AL_NUM_RESAMPLERS_SOFT))],
        lambda: api.alFilteri(4, api.AL_FILTER_TYPE, 1),
        lambda: api.alFilterf(4, 2, 0.25),
        lambda: [api.alGetFilteri(4, api.AL_FILTER_TYPE),
                 api.alGetFilterf(4, 1), api.alGetFilterfv(4, 2)],
        lambda: api.alFilterf(4, 3, 0.5),
        lambda: api.alEffecti(5, api.AL_EFFECT_TYPE, 0x8000),
        lambda: api.alEffectf(5, 6, 3.5),
        lambda: api.alEffectfv(5, 0x0B, [0.1, 0.2, 0.3]),
        lambda: [api.alGetEffecti(5, api.AL_EFFECT_TYPE),
                 api.alGetEffectf(5, 6), api.alGetEffectfv(5, 0x0B)],
        lambda: api.alEffecti(5, api.AL_EFFECT_TYPE, 0x7777),
        lambda: api.alAuxiliaryEffectSloti(6, api.AL_EFFECTSLOT_EFFECT, 5),
        lambda: api.alAuxiliaryEffectSlotf(6, api.AL_EFFECTSLOT_GAIN, 0.7),
        lambda: [api.alGetAuxiliaryEffectSloti(6, api.AL_EFFECTSLOT_EFFECT),
                 api.alGetAuxiliaryEffectSlotf(6, api.AL_EFFECTSLOT_GAIN),
                 api.alGetAuxiliaryEffectSlotiv(
                     6, api.AL_EFFECTSLOT_AUXILIARY_SEND_AUTO)],
        lambda: api.alAuxiliaryEffectSloti(6, 0x77, 1),
        lambda: api.alSource3i(1, api.AL_AUXILIARY_SEND_FILTER, 6, 0, 4),
        lambda: api.alSourcei(2, api.AL_DIRECT_FILTER, 4),
        lambda: api.alBufferDataRaw(
            3, api.AL_FORMAT_STEREO16,
            (np.arange(400, dtype=np.int16) * 50).tobytes(), 22050),
        lambda: [api.alGetBufferi(3, p) for p in (
            api.AL_FREQUENCY, api.AL_CHANNELS, api.AL_BITS, api.AL_SIZE)],
        lambda: api.alBufferiv(3, api.AL_LOOP_POINTS_SOFT, [10, 150]),
        lambda: api.alGetBufferiv(3, api.AL_LOOP_POINTS_SOFT),
        lambda: api.alBufferiv(3, api.AL_LOOP_POINTS_SOFT, [150, 10]),
        lambda: api.alBufferSubDataRawSOFT(
            3, api.AL_FORMAT_STEREO16, b"\x01\x02" * 8, 16),
        lambda: bytes(api.alMapBufferSOFT(3, 8, 16)),
        lambda: api.alUnmapBufferSOFT(3),
        lambda: api.alBufferSubDataRawSOFT(
            3, api.AL_FORMAT_STEREO16, b"\x00" * 8, 4000),
        lambda: api.alBufferi(3, api.AL_UNPACK_BLOCK_ALIGNMENT_SOFT, 64),
        lambda: api.alBufferf(3, api.AL_FREQUENCY, 1.0),
        lambda: api.alEAXSetBufferMode([3], api.AL_STORAGE_HARDWARE),
        lambda: api.alEAXGetBufferMode(3),
        lambda: api.alEAXSetBufferMode([3], 0x1),
        lambda: [api.alIsSource(1), api.alIsSource(77), api.alIsBuffer(0),
                 api.alIsBuffer(3), api.alIsFilter(4), api.alIsEffect(5),
                 api.alIsAuxiliaryEffectSlot(6),
                 api.alIsAuxiliaryEffectSlot(7)],
        lambda: api.alDeferUpdatesSOFT(),
        lambda: api.alIsDeferredSOFT(),
        lambda: api.alProcessUpdatesSOFT(),
        lambda: api.alIsDeferredSOFT(),
        lambda: api.alDeleteSources([1]),
        lambda: api.alIsSource(1),
        lambda: api.alDeleteAuxiliaryEffectSlots(6),
        lambda: api.alDeleteEffects([5]),
        lambda: api.alDeleteFilters(4),
        lambda: api.alDeleteBuffers([3]),
        lambda: [api.alIsBuffer(3), api.alIsEffect(5), api.alIsFilter(4)],
        lambda: api.alGetString(api.AL_EXTENSIONS),
        lambda: [api.alGetString(p) for p in (api.AL_VERSION,
                                              api.AL_RENDERER,
                                              api.AL_VENDOR)],
        lambda: api.alcGetString(dev, api.ALC_EXTENSIONS),
        lambda: [api.alIsExtensionPresent(n) for n in (
            "AL_EXT_FLOAT32", "al_soft_events", "EAX5.0", "AL_NOPE")],
        lambda: [api.alcIsExtensionPresent(dev, n) for n in (
            "ALC_SOFT_loopback", "ALC_SOFT_system_events", "ALC_NOPE")],
        lambda: [api.alGetEnumValue(n) for n in (
            "AL_SOURCE_STATE", "AL_FORMAT_MONO16", "ALC_CONNECTED",
            "AL_NOT_AN_ENUM")],
        lambda: api.alcGetEnumValue(dev, "ALC_MONO_SOURCES"),
        lambda: api.alcGetIntegerv(dev, api.ALC_ATTRIBUTES_SIZE),
        lambda: api.alcGetStringiSOFT(dev, api.ALC_HRTF_SPECIFIER_SOFT, 0),
        lambda: api.alEnable(0x1234),
        lambda: api.alIsEnabled(dbg.AL_DEBUG_OUTPUT_EXT),
    ]
    seen = []
    for call in calls:
        try:
            val = call()
        except Exception as exc:   # noqa: BLE001 - the outcome is compared
            val = type(exc).__name__
        seen.append((val, api.alGetError()))
    return seen


def test_host_calls_and_error_codes_match_jax():
    want = _host_calls(jax_api)
    got = _host_calls(port_api)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    # The sequence exercised every error code the shield sets.
    codes = {err for _, err in want}
    assert {jax_api.AL_INVALID_NAME, jax_api.AL_INVALID_ENUM,
            0xA003} <= codes


def test_global_float_queries_answer():
    """alGetFloat and friends: the listener's values (the JAX module names
    AL_DOPPLER_FACTOR without defining it, so it cannot answer)."""
    dev = port_api.alcLoopbackOpenDeviceSOFT(RATE, capacity=8, device="cpu")
    ctx = port_api.alcCreateContext(dev)
    port_api.alcMakeContextCurrent(ctx)
    port_api.alDopplerFactor(2.5)
    port_api.alSpeedOfSound(300.0)
    port_api.alDopplerVelocity(1.5)
    assert port_api.alGetFloat(port_api.AL_DOPPLER_FACTOR) == 2.5
    assert port_api.alGetDouble(port_api.AL_SPEED_OF_SOUND_ENUM) == 300.0
    assert port_api.alGetFloatv(port_api.AL_DOPPLER_VELOCITY) == [1.5]
    assert port_api.alGetFloat(port_api.AL_GAIN_LIMIT_SOFT) == 16.0
    assert port_api.alGetBoolean(port_api.AL_DOPPLER_FACTOR) is True
    assert port_api.alGetError() == port_api.AL_NO_ERROR
    assert port_api.alGetFloat(0x7777) == 0
    assert port_api.alGetError() == port_api.AL_INVALID_ENUM


def _debug_calls(api):
    api.alcMakeContextCurrent(api.alcCreateContext(_open(api)))
    got = []
    seen = []
    A, M = dbg.AL_DEBUG_SOURCE_APPLICATION_EXT, dbg.AL_DEBUG_TYPE_MARKER_EXT
    H, L = dbg.AL_DEBUG_SEVERITY_HIGH_EXT, dbg.AL_DEBUG_SEVERITY_LOW_EXT
    api.alDebugMessageInsertEXT(A, M, 7, H, "hello")
    api.alDebugMessageInsertEXT(A, M, 8, L, "low")
    api.alDebugMessageInsertEXT(0x9999, M, 8, H, "bad source")
    seen.append(api.alGetError())
    api.alDebugMessageControlEXT(dbg.AL_DONT_CARE_EXT, dbg.AL_DONT_CARE_EXT,
                                 H, (), False)
    api.alDebugMessageInsertEXT(A, M, 9, H, "hidden")
    api.alDebugMessageControlEXT(A, M, dbg.AL_DONT_CARE_EXT, (9,), True)
    api.alDebugMessageInsertEXT(A, M, 9, H, "visible")
    api.alDebugMessageControlEXT(A, M, H, (9,), True)
    seen.append(api.alGetError())
    api.alPushDebugGroupEXT(A, 42, "grp")
    api.alDebugMessageInsertEXT(A, M, 10, H, "in-group")
    api.alPopDebugGroupEXT()
    api.alPopDebugGroupEXT()
    seen.append(api.alGetError())
    seen.append(api.alGetDebugMessageLogEXT(64))
    api.alDebugMessageCallbackEXT(lambda *a: got.append(a), user_param="up")
    api.alDebugMessageInsertEXT(A, dbg.AL_DEBUG_TYPE_OTHER_EXT, 1,
                                dbg.AL_DEBUG_SEVERITY_MEDIUM_EXT, "cb")
    api.alDisable(dbg.AL_DEBUG_OUTPUT_EXT)
    api.alDebugMessageInsertEXT(A, dbg.AL_DEBUG_TYPE_OTHER_EXT, 2,
                                dbg.AL_DEBUG_SEVERITY_MEDIUM_EXT, "off")
    api.alEnable(dbg.AL_DEBUG_OUTPUT_EXT)
    seen.append(api.alIsEnabled(dbg.AL_DEBUG_OUTPUT_EXT))
    sid = api.alGenSources(1)
    api.alObjectLabelEXT("source", sid, "player-footsteps")
    seen.append(api.alGetObjectLabelEXT("source", sid))
    api.alObjectLabelEXT("source", sid, None)
    seen.append(api.alGetObjectLabelEXT("source", sid))
    seen.append(api.alGetError())
    return seen, got


def test_debug_messages_match_jax():
    want = _debug_calls(jax_api)
    got = _debug_calls(port_api)
    assert got == want
    assert [m[4] for m in got[0][3]] and got[1]


def _event_calls(api):
    dev = _open(api)
    ctx, buf, src = _tone_scene(api, dev)
    got = []
    api.alEventCallbackSOFT(lambda kind, oid, param: got.append(
        (kind, oid, param)))
    api.alEventControlSOFT([api.AL_EVENT_TYPE_SOURCE_STATE_CHANGED_SOFT,
                            api.AL_EVENT_TYPE_BUFFER_COMPLETED_SOFT], True)
    api.alSourcei(src, api.AL_LOOPING, api.AL_FALSE)
    api.alSourcePlay(src)
    api.alcRenderSamplesSOFT(dev, 2048)
    api.alSourceStop(src)
    api.alcRenderSamplesSOFT(dev, 2048)
    want = len(ctx.events)
    deadline = time.time() + 5.0
    while len(got) < want and time.time() < deadline:
        time.sleep(0.005)
    return list(ctx.events), got


def test_events_match_jax():
    want = _event_calls(jax_api)
    got = _event_calls(port_api)
    assert got == want
    assert ("source_state" in [e[0] for e in got[1]])


@pytest.mark.parametrize("scene", ["best_case", "speakers_filtered"])
def test_api_scene_is_bit_equal_to_the_direct_scene(scene):
    """chip_smoke.py's phase-26 scenes at 16 voices on the CPU: built
    through the API and directly, rendered in whole, multi-block and odd
    calls, bit for bit."""
    kw = ({} if scene == "best_case"
          else {"loaded": True, "filtered": True, "hrtf": False})
    direct = chip_smoke.bench_scene(16, 16, "cpu", **kw)
    dev = chip_smoke.api_open_loopback(16, "cpu", hrtf=kw.get("hrtf", True))
    ctx, sids = chip_smoke.api_scene(dev, 16, loaded=kw.get("loaded", False),
                                     filtered=kw.get("filtered", False))
    assert port_api.alGetError() == port_api.AL_NO_ERROR
    for n in (2048, 1024, 100):
        if n == 100:
            # The clock counts the frames rendered so far.
            assert port_api.alcGetInteger64vSOFT(
                dev, port_api.ALC_DEVICE_CLOCK_SOFT) == \
                3072 * 1_000_000_000 // chip_smoke.RATE
        want, got = direct.render_samples(n), dev.render_samples(n)
        assert np.array_equal(got, want)
    assert np.abs(got).max() > 0
    states = {port_api.alGetSourcei(s, port_api.AL_SOURCE_STATE)
              for s in sids}
    assert states == {port_api.AL_PLAYING}


def test_default_devices_render_on_the_card():
    """Without device=, both entry points open on "cuda": here, with no
    card, they raise; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        dev = port_api.alcLoopbackOpenDeviceSOFT(capacity=4)
        assert dev.torch_device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        port_api.alcLoopbackOpenDeviceSOFT()
    with pytest.raises(RuntimeError, match="cuda"):
        port_api.alcOpenDevice(capacity=4)
    with pytest.raises(RuntimeError, match="cuda"):
        port_api.alcOpenDevice("Null Output", capacity=4)


def test_card_errors_are_not_al_errors(monkeypatch):
    """The shield turns only ALError, KeyError and ValueError into AL
    error codes: a RuntimeError from the device (as a failed kernel build
    or launch raises) propagates out of the al* entry point."""
    from openal_soft_tpu_torch.core.device import RenderDevice

    ctx, buf, src = _tone_scene(port_api, _open(port_api))

    def fail(self, n):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(RenderDevice, "alloc_rows", fail)
    with pytest.raises(RuntimeError, match="CUDA error"):
        port_api.alSourcePlay(src)
    assert port_api.alGetError() == port_api.AL_NO_ERROR


def test_al_entry_points_launch_no_kernel(monkeypatch):
    """Every kernel wrapper the render device calls raises here, and a
    scene's whole al* build (buffers, filters, a slot, sources, play,
    getters) still runs: only alcRenderSamplesSOFT reaches a kernel, so no
    kernel's ValueError can turn into an AL error code."""
    import importlib
    import sys

    def trap(*args, **kwargs):
        raise RuntimeError("a kernel was launched")

    trapped = 0
    for kernel in ("biquad", "effect_scan", "resample_gen", "resample_span",
                   "resample_unit", "resample_voice", "reverb"):
        mod = importlib.import_module(
            f"openal_soft_tpu_torch.ops.kernels.{kernel}")
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (callable(fn) and hasattr(fn, "launches")):
                continue
            # The wrapper, wherever a module imported it by name.
            for user in list(sys.modules.values()):
                if (getattr(user, "__name__", "").startswith(
                        "openal_soft_tpu_torch")
                        and getattr(user, name, None) is fn):
                    monkeypatch.setattr(user, name, trap)
                    trapped += 1
    assert trapped >= 7
    dev = chip_smoke.api_open_loopback(8, "cpu", hrtf=False)
    ctx, sids = chip_smoke.api_scene(dev, 8, loaded=True, filtered=True)
    for sid in sids:
        port_api.alGetSourcei(sid, port_api.AL_SAMPLE_OFFSET)
        port_api.alGetSourcedvSOFT(sid, port_api.AL_SEC_OFFSET_LATENCY_SOFT)
    assert port_api.alGetError() == port_api.AL_NO_ERROR
    with pytest.raises(RuntimeError, match="kernel was launched"):
        port_api.alcRenderSamplesSOFT(dev, 1024)
