"""The port's playback-device lifecycle (alc/lifecycle.py), system events,
backends and the device's disconnect state, against the JAX package's on
the CPU.

Renders without slots or filters agree within 1e-5; host state (routing,
negotiated formats, source states and offsets, ALC_CONNECTED, event
sequences) is compared exactly.  A wave or ALSA device's output is
bit-equal to a port loopback device's render of the same scene in the
same calls.  The tone scene is ``tests/test_al_api.py``'s (44.1 kHz,
capacity 8), so the JAX renders share its compiled graphs.
"""

import pathlib
import subprocess
import time

import numpy as np
import pytest

import chip_smoke
from openal_soft_tpu.al import api as jax_api
from openal_soft_tpu.alc import config as jax_conf
from openal_soft_tpu.alc import events as jax_events
from openal_soft_tpu.alc import lifecycle as jax_life
from openal_soft_tpu_torch.al import api as port_api
from openal_soft_tpu_torch.alc import config as port_conf
from openal_soft_tpu_torch.alc import events as port_events
from openal_soft_tpu_torch.alc import lifecycle as port_life
from tests.test_torch_api import (_tone_scene,  # noqa: F401
                                   jax_renders_from_private_copies)

HERE = pathlib.Path(__file__).parent
RATE = 44100
TOL = 1e-5
PACKAGES = {"jax": (jax_api, jax_life, {}),
            "port": (port_api, port_life, {"device": "cpu"})}


@pytest.fixture
def conf(tmp_path, monkeypatch):
    """conf(text): both packages read ``text`` as their alsoft.conf for the
    rest of the test; the real backends' libraries are hidden."""
    from openal_soft_tpu.alc import alsa as jax_alsa
    from openal_soft_tpu.alc import pulse as jax_pulse
    from openal_soft_tpu_torch.alc import alsa as port_alsa
    from openal_soft_tpu_torch.alc import pulse as port_pulse

    monkeypatch.setenv("OPENAL_TPU_ALSA_LIB", "/nonexistent/libasound.so")
    monkeypatch.setenv("OPENAL_TPU_PULSE_LIB", "/nonexistent/libpulse.so")
    for mod in (jax_alsa, jax_pulse, port_alsa, port_pulse):
        monkeypatch.setattr(mod, "_lib_cache", None)

    def load(text: str) -> None:
        path = tmp_path / "alsoft.conf"
        path.write_text(text)
        monkeypatch.setenv("ALSOFT_CONF", str(path))
        jax_conf.load_config(reload=True)
        port_conf.load_config(reload=True)

    load("")
    yield load
    monkeypatch.delenv("ALSOFT_CONF")
    jax_conf.load_config(reload=True)
    port_conf.load_config(reload=True)


def _playing(api, dev):
    """tests/test_al_api.py's tone scene on ``dev``, playing."""
    ctx, _, src = _tone_scene(api, dev)
    api.alSourcePlay(src)
    return ctx, src


# (alsoft.conf, attributes, render keywords)
FORMAT_CASES = [
    ("", None, {}),
    ("", [0x1007, 44100, 0x1010, 30, 0x1011, 8, 0], {}),
    ("frequency = 22050\nchannels = surround51\nsample-type = int16\n",
     {0x20003: 9}, {}),
    ("channels = quad\nsample-type = int8\nsends = 3\nsources = 100\n",
     [(0x1007, 4000)], {}),
    ("hrtf = true\n", None, {}),
    ("stereo-mode = headphones\n", [0x1992, 0, 0], {}),
    ("stereo-mode = headphones\n", None, {"capacity": 32}),
    ("", {0x1992: 1, 0x1007: 250000}, {"num_aux_sends": 1}),
]


@pytest.mark.parametrize("case", range(len(FORMAT_CASES)))
def test_negotiated_format_matches_jax(conf, case):
    text, attrs, render_kw = FORMAT_CASES[case]
    conf(text)
    out = {}
    for name, (_, life, _) in PACKAGES.items():
        dev = object.__new__(life.PlaybackDevice)
        dev._attrs = life._parse_attrs(attrs)
        dev._render_kw = dict(render_kw)
        freq, ch, ty, kw = dev._negotiated_format()
        out[name] = (freq, ch.name, ty.name,
                     {k: getattr(v, "name", v) for k, v in kw.items()})
    assert out["port"] == out["jax"]


ROUTE_CASES = [
    ("", None), ("", "Null Output"), ("", "Wave File Writer"),
    ("", "No Such Device"), ("drivers = wave,null\n", None),
    ("drivers = wave,null\n[wave]\nfile = /dev/null\n", None),
    ("drivers = alsa\n", None), ("drivers = pulse,alsa\n", ""),
]


@pytest.mark.parametrize("case", range(len(ROUTE_CASES)))
def test_routing_matches_jax(conf, case):
    text, name = ROUTE_CASES[case]
    conf(text)
    out = {}
    for pkg, (_, life, _) in PACKAGES.items():
        try:
            routed = life.PlaybackDevice._route_name(name)
        except ValueError as exc:
            routed = str(exc)
        out[pkg] = (routed, life.enumerate_devices())
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("hold", [False, True])
def test_disconnect_matches_jax(hold):
    """The device's disconnect state: ALC_CONNECTED drops to 0 once, the
    disconnect event reaches the AL_SOFT_events callback, and the voices
    stop unless the context holds them."""
    out = {}
    for name, (api, _, kw) in PACKAGES.items():
        dev = api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                            capacity=8, **kw)
        ctx, src = _playing(api, dev)
        ctx.hold_on_disconnect = hold
        got = []
        api.alEventCallbackSOFT(lambda *a: got.append(a))
        api.alEventControlSOFT([api.AL_EVENT_TYPE_DISCONNECTED_SOFT,
                                api.AL_EVENT_TYPE_SOURCE_STATE_CHANGED_SOFT],
                               True)
        seen = [api.alcGetIntegerv(dev, api.ALC_CONNECTED)]
        renders = [api.alcRenderSamplesSOFT(dev, 2048)]
        seen.append(api.alGetSourcei(src, api.AL_SOURCE_STATE))
        dev.handle_disconnect("backend lost")
        dev.handle_disconnect("again")
        seen += [api.alcGetIntegerv(dev, api.ALC_CONNECTED),
                 api.alcGetIntegerv(dev, api.ALC_ALL_ATTRIBUTES),
                 api.alGetSourcei(src, api.AL_SOURCE_STATE),
                 api.alGetSourcei(src, api.AL_SAMPLE_OFFSET)]
        renders.append(api.alcRenderSamplesSOFT(dev, 2048))
        seen += [api.alGetSourcei(src, api.AL_SOURCE_STATE),
                 api.alGetSourcei(src, api.AL_SAMPLE_OFFSET),
                 api.alGetError()]
        deadline = time.time() + 5.0
        while len(got) < len(ctx.events) and time.time() < deadline:
            time.sleep(0.005)
        out[name] = (renders, seen, list(ctx.events), got)
    for g, w in zip(out["port"][0], out["jax"][0]):
        assert float(np.abs(g - w).max()) <= TOL
    assert out["port"][1:] == out["jax"][1:]
    assert out["port"][1][0] == 1 and out["port"][1][2] == 0
    assert ("disconnected", 0, "backend lost") in out["port"][3]
    stopped = out["port"][1][4] == port_api.AL_STOPPED
    assert stopped != hold


def _wave_data(path) -> tuple[bytes, np.ndarray]:
    raw = pathlib.Path(path).read_bytes()
    return raw[:44], np.frombuffer(raw[44:], np.float32)


def test_wave_device_matches_jax(conf, tmp_path):
    """The wave writer through alcOpenDevice: the same header and, within
    1e-5, the same samples as the JAX package's, then reset and reopen
    with the source still playing."""
    out = {}
    for name, (api, life, kw) in PACKAGES.items():
        path = tmp_path / f"{name}.wav"
        conf(f"[wave]\nfile = {path}\n")
        dev = api.alcOpenDevice("Wave File Writer", capacity=8, **kw)
        api.alcDevicePauseSOFT(dev)
        dev.reset([0x1007, RATE, 0])
        ctx, src = _playing(api, dev)
        seen = [dev.name, dev.state.name]
        for _ in range(2):
            dev.backend.render(2048)
        seen += [api.alGetSourcei(src, api.AL_SAMPLE_OFFSET),
                 api.alcGetInteger64vSOFT(dev.render,
                                          api.ALC_DEVICE_CLOCK_SOFT)]
        dev.backend.close()
        header, data = _wave_data(path)
        dev.backend = None
        api.alcResetDeviceSOFT(dev)
        dev.backend.render(2048)
        seen += [api.alGetSourcei(src, api.AL_SOURCE_STATE),
                 api.alGetSourcei(src, api.AL_SAMPLE_OFFSET),
                 api.alcGetIntegerv(dev, api.ALC_CONNECTED),
                 api.alcGetIntegerv(dev, api.ALC_ALL_ATTRIBUTES)]
        api.alcReopenDeviceSOFT(dev, "Null Output", [0x1010, 12, 0])
        seen += [dev.name, api.alcGetIntegerv(dev, api.ALC_MONO_SOURCES),
                 api.alGetSourcei(src, api.AL_SOURCE_STATE)]
        api.alcCloseDevice(dev)
        out[name] = (header, data, seen)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1].size == 2 * 4096
    assert float(np.abs(out["port"][1] - out["jax"][1]).max()) <= TOL
    assert out["port"][2] == out["jax"][2]


def test_reset_and_reopen_keep_the_torch_device(conf):
    """The render devices that reset and reopen build take the old one's
    torch device, never the default ("cuda" raises here), and a migrated
    slot's effect state belongs to the new render device."""
    dev = port_api.alcOpenDevice("Null Output", capacity=16, device="cpu")
    port_api.alcDevicePauseSOFT(dev)
    ctx, sids = chip_smoke.api_scene(dev, 4, loaded=True, filtered=True)
    first = dev.render.render_samples(1024)
    old = dev.render
    port_api.alcResetDeviceSOFT(dev, [0x20003, 1, 0])
    assert dev.render is not old and dev.render.torch_device.type == "cpu"
    assert dev.render.pool._device is None and dev.render.pool._dirty
    for slot in ctx.aux_slots.values():
        assert slot.device is dev.render and slot.state.device is dev.render
    port_api.alcReopenDeviceSOFT(dev, "Null Output", [0x1007, 44100, 0])
    assert dev.render.torch_device.type == "cpu"
    assert dev.render.sample_rate == 44100
    out = dev.render.render_samples(1024)
    assert np.isfinite(out).all() and np.abs(out).max() > 0
    assert np.abs(first).max() > 0
    assert {port_api.alGetSourcei(s, port_api.AL_SOURCE_STATE)
            for s in sids} == {port_api.AL_PLAYING}
    port_api.alcCloseDevice(dev)


def test_wave_device_is_bit_equal_to_the_loopback(conf, tmp_path):
    """chip_smoke.py's phase 28 at 16 voices on the CPU: the filtered
    scene through the API on the wave writer, rendered in 1024-frame
    periods with pause and resume between them, is bit-equal to a
    loopback device's render in the same calls; after a reset the voices
    play on from where they were, on the same torch device, connected."""
    path = tmp_path / "out.wav"
    conf(f"[wave]\nfile = {path}\n")
    dev = port_api.alcOpenDevice(
        "Wave File Writer", attrs=[port_api.ALC_MONO_SOURCES, 64, 0],
        device="cpu")
    port_api.alcDevicePauseSOFT(dev)
    ctx, sids = chip_smoke.api_scene(dev, 16, loaded=True, filtered=True)
    periods = 0
    for _ in range(3):
        dev.backend.render(1024)
        periods += 1
        port_api.alcDevicePauseSOFT(dev)
        port_api.alcDeviceResumeSOFT(dev)
        port_api.alcDevicePauseSOFT(dev)
    dev.backend._fh.flush()
    written = dev.backend._frames_written
    assert written % 1024 == 0 and written >= 3 * 1024
    _, data = _wave_data(path)
    data = data[:written * 2].reshape(-1, 2)
    lb = chip_smoke.api_open_loopback(64, "cpu", hrtf=False)
    chip_smoke.api_scene(lb, 16, loaded=True, filtered=True)
    want = np.concatenate([lb.render_samples(1024)
                           for _ in range(written // 1024)])
    assert np.array_equal(data, want)
    port_api.alcMakeContextCurrent(ctx)
    offsets = [port_api.alGetSourcei(s, port_api.AL_SAMPLE_OFFSET)
               for s in sids]
    port_api.alcResetDeviceSOFT(dev)
    dev.backend.render(1024)
    assert dev.render.torch_device.type == "cpu"
    assert port_api.alcGetIntegerv(dev, port_api.ALC_CONNECTED) == 1
    assert {port_api.alGetSourcei(s, port_api.AL_SOURCE_STATE)
            for s in sids} == {port_api.AL_PLAYING}
    after = [port_api.alGetSourcei(s, port_api.AL_SAMPLE_OFFSET)
             for s in sids]
    assert all(a != o for a, o in zip(after, offsets))
    port_api.alcCloseDevice(dev)


def test_null_device_thread_renders_and_pauses(conf):
    dev = port_api.alcOpenDevice("Null Output", capacity=8, device="cpu")
    assert dev.name == port_life.NULL_DEVICE_NAME
    port_api.alcDevicePauseSOFT(dev)
    ctx, src = _playing(port_api, dev)
    port_api.alcDeviceResumeSOFT(dev)
    assert dev.state == port_life.DeviceState.PLAYING
    deadline = time.time() + 20.0
    while dev.backend.frames_rendered < 4096 and time.time() < deadline:
        time.sleep(0.01)
    port_api.alcDevicePauseSOFT(dev)
    frames = dev.backend.frames_rendered
    assert frames >= 4096
    time.sleep(0.1)
    assert dev.backend.frames_rendered == frames
    assert port_api.alGetSourcei(src, port_api.AL_SAMPLE_OFFSET) > 0
    port_api.alcCloseDevice(dev)
    assert dev.state == port_life.DeviceState.UNPREPARED


def _event_sequence(api, events, kw):
    got = []
    events.alcEventCallbackSOFT(lambda *a: got.append(
        (a[0], a[1], a[3], a[4])), "user")
    res = [events.alcEventControlSOFT(
        [events.ALC_EVENT_TYPE_DEVICE_ADDED_SOFT,
         events.ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT], True),
        events.alcEventControlSOFT([0x1234], True)]
    res += [events.alcEventIsSupportedSOFT(t, d) for t in (
        events.ALC_EVENT_TYPE_DEFAULT_DEVICE_CHANGED_SOFT,
        events.ALC_EVENT_TYPE_DEVICE_ADDED_SOFT,
        events.ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT) for d in (
        events.ALC_PLAYBACK_DEVICE_SOFT, events.ALC_CAPTURE_DEVICE_SOFT)]
    dev = api.alcOpenDevice("Null Output", capacity=8, **kw)
    api.alcDevicePauseSOFT(dev)
    api.alcResetDeviceSOFT(dev)
    api.alcReopenDeviceSOFT(dev, "Wave File Writer")
    api.alcReopenDeviceSOFT(dev, "Wave File Writer")
    api.alcCloseDevice(dev)
    events.alcEventControlSOFT([events.ALC_EVENT_TYPE_DEVICE_ADDED_SOFT,
                                events.ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT],
                               False)
    dev = api.alcOpenDevice("Null Output", capacity=8, **kw)
    api.alcCloseDevice(dev)
    events.alcEventCallbackSOFT(None)
    return res, got


def test_system_events_match_jax(conf, tmp_path):
    conf(f"[wave]\nfile = {tmp_path / 'ev.wav'}\n")
    want = _event_sequence(jax_api, jax_events, {})
    got = _event_sequence(port_api, port_events, {"device": "cpu"})
    assert got == want
    assert len(got[1]) == 4


@pytest.fixture(scope="module")
def fake_alsa(tmp_path_factory):
    lib = tmp_path_factory.mktemp("alsa") / "libfakeasound.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2",
                    "-o", str(lib), str(HERE / "fake_alsa.c")], check=True)
    return str(lib)


def test_alsa_device_is_bit_equal_to_the_loopback(conf, fake_alsa, tmp_path,
                                                  monkeypatch):
    """The ALSA output on the fake libasound, routed by default: the PCM
    it wrote is bit-equal to a loopback render of the same scene."""
    from openal_soft_tpu_torch.alc import alsa

    cap = tmp_path / "cap.pcm"
    monkeypatch.setenv("OPENAL_TPU_ALSA_LIB", fake_alsa)
    monkeypatch.setenv("FAKE_ALSA_CAPTURE", str(cap))
    monkeypatch.setattr(alsa, "_lib_cache", None)
    dev = port_api.alcOpenDevice(capacity=8, device="cpu")
    assert dev.name == port_life.ALSA_DEVICE_NAME
    try:
        port_api.alcDevicePauseSOFT(dev)
        _playing(port_api, dev)
        port_api.alcDeviceResumeSOFT(dev)
        deadline = time.time() + 30
        while dev.backend.frames_written < 4096 and time.time() < deadline:
            time.sleep(0.01)
        port_api.alcDevicePauseSOFT(dev)
        data = np.frombuffer(cap.read_bytes(), np.float32).reshape(-1, 2)
        assert data.shape[0] >= 4096
        lb = port_api.alcLoopbackOpenDeviceSOFT(48000, "stereo", "float32",
                                                capacity=8, device="cpu")
        _playing(port_api, lb)
        want = np.concatenate([lb.render_samples(1024) for _ in range(4)])
        assert np.array_equal(data[:4096], want)
    finally:
        port_api.alcCloseDevice(dev)


def test_api_threads_and_the_mixer_thread_share_the_device(conf):
    """Three application threads set source properties and stop and
    restart sources through the API while the null output's mixer thread
    renders: no exception, no AL error, and every voice row returns once
    the sources stop (the render device's lock serialises both sides)."""
    import sys
    import threading

    # Four sources, each restarted three times per thread: a restarted
    # source holds its fading voice's row until the mixer's next block, so
    # up to 4 + 9 rows are in use.  Below 32 rows the mixer's torch ops run
    # on one thread, which keeps the test short beside other workers.
    dev = port_api.alcOpenDevice("Null Output", capacity=24, device="cpu")
    ctx = port_api.alcCreateContext(dev)          # the mixer thread starts
    port_api.alcMakeContextCurrent(ctx)
    buf = port_api.alGenBuffers()
    port_api.alBufferData(buf, port_api.AL_FORMAT_MONO_FLOAT32,
                          (0.3 * np.sin(np.arange(4800) * 0.05)
                           ).astype(np.float32), 48000)
    sids = port_api.alGenSources(4)
    for sid in sids:
        port_api.alSourcei(sid, port_api.AL_BUFFER, buf)
        port_api.alSourcei(sid, port_api.AL_LOOPING, port_api.AL_TRUE)
        port_api.alSourcePlay(sid)
    errors, codes = [], []

    def hammer(seed):
        port_api.alcMakeContextCurrent(ctx)       # the context is per thread
        rng = np.random.default_rng(seed)
        try:
            for i in range(300):
                sid = sids[i % len(sids)]
                port_api.alSource3f(sid, port_api.AL_POSITION,
                                    *rng.standard_normal(3))
                port_api.alSourcef(sid, port_api.AL_GAIN,
                                   float(rng.uniform(0.1, 1.0)))
                if i % 100 == 99:
                    port_api.alSourceStop(sid)
                    port_api.alSourcePlay(sid)
            codes.append(port_api.alGetError())
        except Exception as exc:   # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        base = dev.backend.frames_rendered
        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        deadline = time.time() + 30.0
        while (dev.backend.frames_rendered < base + 4096
               and time.time() < deadline):
            time.sleep(0.01)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert codes == [port_api.AL_NO_ERROR] * 3
    assert dev.backend.frames_rendered >= base + 4096
    port_api.alcDevicePauseSOFT(dev)
    for sid in sids:
        port_api.alSourceStop(sid)
    for _ in range(4):
        dev.render.render_samples(1024)
    assert len(dev.render._free_rows) == dev.render.capacity
    port_api.alcCloseDevice(dev)
