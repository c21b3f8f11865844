"""The port's capture path against the JAX package: converters, capture
devices and the capture entry points, plus the PulseAudio backend without
the reference side's three faults (ROADMAP C4).

Both packages run the same numpy host code, so every output is compared
exactly.  The PulseAudio and ALSA backends run against the fake libraries
that ``tests/test_pulse.py`` and ``tests/test_capture_alsa.py`` compile.
"""

import ctypes
import pathlib
import struct
import subprocess
import threading
import time

import numpy as np
import pytest

from openal_soft_tpu.al import api as jax_api
from openal_soft_tpu.alc import capture as jax_capture
from openal_soft_tpu.core import converter as jax_conv
from openal_soft_tpu.core.devformat import DevFmtType as JaxFmt
from openal_soft_tpu_torch.al import api as port_api
from openal_soft_tpu_torch.alc import capture as port_capture
from openal_soft_tpu_torch.constants import Resampler
from openal_soft_tpu_torch.core import converter as port_conv
from openal_soft_tpu_torch.core.devformat import DevFmtType

HERE = pathlib.Path(__file__).parent
RATE = 44100
f32 = np.float32

_TYPES = ("UBYTE", "BYTE", "SHORT", "USHORT", "INT", "UINT", "FLOAT")
_NP = {"UBYTE": np.uint8, "BYTE": np.int8, "SHORT": np.int16,
       "USHORT": np.uint16, "INT": np.int32, "UINT": np.uint32,
       "FLOAT": np.float32}


def _raw(rng, typ: str, n: int) -> np.ndarray:
    if typ == "FLOAT":
        return (rng.standard_normal(n) * 0.6).astype(f32)
    info = np.iinfo(_NP[typ])
    return rng.integers(info.min, info.max, n, endpoint=True).astype(_NP[typ])


@pytest.mark.parametrize("typ", _TYPES)
def test_load_and_store_match_jax(typ):
    rng = np.random.default_rng(11)
    raw = _raw(rng, typ, 4099)
    want = jax_conv.load_samples(raw, JaxFmt[typ])
    got = port_conv.load_samples(raw, DevFmtType[typ])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4096),
                        [0.0, 1.0, -1.0, 0.5 / 32768, 1.5 / 32768]]).astype(f32)
    want = np.asarray(jax_conv.store_samples(x, JaxFmt[typ]))
    got = np.asarray(port_conv.store_samples(x, DevFmtType[typ]))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_type,n_in,mask,layout", [
    ("SHORT", 1, 0x1, "stereo"), ("SHORT", 2, 0x3, "mono"),
    ("FLOAT", 2, 0x1, "mono"), ("UBYTE", 2, 0x3, "mono"),
    ("INT", 1, 0x1, "stereo")])
def test_channel_converter_matches_jax(src_type, n_in, mask, layout):
    rng = np.random.default_rng(12)
    frames = 1531
    raw = _raw(rng, src_type, frames * n_in)
    want = jax_conv.ChannelConverter(JaxFmt[src_type], n_in, mask,
                                     layout).convert(raw, frames)
    got = port_conv.ChannelConverter(DevFmtType[src_type], n_in, mask,
                                     layout).convert(raw, frames)
    np.testing.assert_array_equal(got, want)


_CHUNKS = (1, 7, 13, 400, 1500, 23, 2048, 9, 3000)


@pytest.mark.parametrize("resampler", ["POINT", "LINEAR", "SPLINE",
                                       "GAUSSIAN", "BSINC12", "FAST_BSINC24",
                                       "BSINC48"])
@pytest.mark.parametrize("rates,types", [
    ((44100, 48000), ("FLOAT", "FLOAT")),
    ((48000, 22050), ("SHORT", "FLOAT")),
    ((22050, 44100), ("FLOAT", "SHORT"))])
def test_sample_converter_streams_as_jax(resampler, rates, types):
    """The same chunked stream through both converters: equal outputs and
    equal consumed counts, call by call."""
    from openal_soft_tpu.constants import Resampler as JaxResampler

    rng = np.random.default_rng(13)
    n = sum(_CHUNKS)
    sig = _raw(rng, types[0], 2 * n).reshape(n, 2)
    conv = {
        "jax": jax_conv.SampleConverter(JaxFmt[types[0]], JaxFmt[types[1]],
                                        2, *rates, JaxResampler[resampler]),
        "port": port_conv.SampleConverter(
            DevFmtType[types[0]], DevFmtType[types[1]], 2, *rates,
            Resampler[resampler])}
    pos = 0
    for size in _CHUNKS:
        chunk = sig[pos:pos + size]
        pos += size
        outs = {}
        for k, c in conv.items():
            m = c.available_out(size)
            outs[k] = c.convert(chunk, max(m, 1))
        assert outs["port"][1] == outs["jax"][1]
        np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])


def _capture_all(mod, backend_args, dev_args, reads=(100, 1, 999)):
    """Capture through ``mod``'s CaptureDevice over an unpaced array
    backend: available counts and the frames of each read."""
    backend = mod.ArrayCaptureBackend(*backend_args)
    dev = mod.CaptureDevice(backend, *dev_args)
    seen = [dev.available_samples()]
    dev.start()
    for n in reads:
        avail = dev.available_samples()
        seen.append(avail)
        seen.append(dev.capture_samples(min(n, avail)))
    dev.stop()
    seen.append(dev.available_samples())
    dev.close()
    return seen


@pytest.mark.parametrize("mic_type,mic_ch,rate,channels,sample_type", [
    ("int16", "stereo", 48000, "mono", "float32"),
    ("float32", "mono", 44100, "stereo", "int16"),
    ("uint8", "mono", 22050, "mono", "int32"),
    ("int32", "stereo", 44100, "stereo", "uint8")])
def test_capture_device_matches_jax(mic_type, mic_ch, rate, channels,
                                    sample_type):
    rng = np.random.default_rng(14)
    n_ch = {"mono": 1, "stereo": 2}[mic_ch]
    typ = {"int16": "SHORT", "float32": "FLOAT", "uint8": "UBYTE",
           "int32": "INT"}[mic_type]
    mic = _raw(rng, typ, 6000 * n_ch).reshape(6000, n_ch)
    args = ((mic, RATE, mic_type, mic_ch),
            (rate, channels, sample_type, 4096))
    want = _capture_all(jax_capture, *args)
    got = _capture_all(port_capture, *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _wav(path, rate, sig):
    n = sig.size
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + 2 * n) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate,
                                       rate * 2, 2, 16))
        fh.write(b"data" + struct.pack("<I", 2 * n))
        fh.write(sig.tobytes())


def test_wav_capture_and_entry_points_match_jax(tmp_path):
    rng = np.random.default_rng(15)
    sig = rng.integers(-20000, 20000, 3000).astype(np.int16)
    path = tmp_path / "mic.wav"
    _wav(path, 22050, sig)
    out = {}
    for name, mod, api in (("jax", jax_capture, jax_api),
                           ("port", port_capture, port_api)):
        wav = mod.CaptureDevice(mod.WavCaptureBackend(str(path)), 44100,
                                "mono", "float32", buffer_frames=8192)
        wav.start()
        res = [wav.capture_samples(wav.available_samples())]
        backend = mod.ArrayCaptureBackend(sig, 22050, "int16", "mono")
        dev = api.alcCaptureOpenDevice(backend, 22050,
                                       api.AL_FORMAT_STEREO16, 2048)
        api.alcCaptureStart(dev)
        res.append(api.alcGetIntegerv(dev, api.ALC_CAPTURE_SAMPLES))
        res.append(api.alcCaptureSamplesRaw(dev, 700))
        res.append(api.alcCaptureSamples(dev, 300))
        api.alcCaptureStop(dev)
        res.append(api.alcGetIntegerv(dev, api.ALC_CAPTURE_SAMPLES))
        api.alcCaptureCloseDevice(dev)
        out[name] = res
    for g, w in zip(out["port"], out["jax"]):
        if isinstance(w, bytes):
            assert g == w
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- the ALSA and PulseAudio backends over the fake libraries ---------------

@pytest.fixture(scope="module")
def fake_alsa(tmp_path_factory):
    lib = tmp_path_factory.mktemp("alsa") / "libfakeasound.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2",
                    "-o", str(lib), str(HERE / "fake_alsa.c")], check=True)
    return str(lib)


@pytest.fixture(scope="module")
def fake_pulse(tmp_path_factory):
    lib = tmp_path_factory.mktemp("pulse") / "libfakepulse.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2",
                    "-o", str(lib), str(HERE / "fake_pulse.c")], check=True)
    return str(lib)


def _use_fake(monkeypatch, var: str, lib: str) -> None:
    from openal_soft_tpu.alc import alsa as jax_alsa
    from openal_soft_tpu.alc import pulse as jax_pulse
    from openal_soft_tpu_torch.alc import alsa as port_alsa
    from openal_soft_tpu_torch.alc import pulse as port_pulse

    monkeypatch.setenv(var, lib)
    for mod in (jax_alsa, jax_pulse, port_alsa, port_pulse):
        monkeypatch.setattr(mod, "_lib_cache", None)


def test_alsa_capture_by_name_matches_jax(fake_alsa, monkeypatch):
    """The ALSA record path (pull model) gives both packages the same
    frames through alcCaptureOpenDeviceByName."""
    _use_fake(monkeypatch, "OPENAL_TPU_ALSA_LIB", fake_alsa)
    monkeypatch.setenv("OPENAL_TPU_PULSE_LIB", "/nonexistent/libpulse.so")
    monkeypatch.delenv("FAKE_ALSA_SOURCE", raising=False)
    out = {}
    for name, api in (("jax", jax_api), ("port", port_api)):
        dev = api.alcCaptureOpenDeviceByName("", RATE, 0x1101, 4096)
        assert type(dev.backend).__name__ == "AlsaCaptureBackend"
        api.alcCaptureStart(dev)
        deadline = time.time() + 10
        while dev.available_samples() < 512 and time.time() < deadline:
            time.sleep(0.001)
        out[name] = api.alcCaptureSamples(dev, 512)
        api.alcCaptureStop(dev)
        api.alcCaptureCloseDevice(dev)
    np.testing.assert_array_equal(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"][:, 0],
                                  np.arange(512, dtype=np.int16))


class _Int8Render:
    """A stand-in render device with int8 output: a frame-index ramp."""
    fmt_type = DevFmtType.BYTE
    sample_rate = RATE
    n_real = 2

    def __init__(self):
        self.cursor = 0

    def render_samples(self, n):
        t = np.arange(self.cursor, self.cursor + n)
        self.cursor += n
        return np.stack([t, -t], axis=1).astype(np.int8)

    def handle_disconnect(self, msg):
        raise AssertionError(msg)


def test_pulse_int8_device_opens(fake_pulse, tmp_path, monkeypatch):
    """C4, pulse.py:35: an int8 device opens on PulseAudio.  The stream is
    U8 and carries each rendered sample offset by 128."""
    from openal_soft_tpu_torch.alc import lifecycle, pulse

    cap = tmp_path / "stream.raw"
    _use_fake(monkeypatch, "OPENAL_TPU_PULSE_LIB", fake_pulse)
    monkeypatch.setenv("FAKE_PULSE_CAPTURE", str(cap))
    be = pulse.PulseBackend(_Int8Render())
    be.start(period_frames=256)
    deadline = time.time() + 5.0
    while be.frames_written < 1024 and time.time() < deadline:
        time.sleep(0.01)
    be.close()
    raw = np.frombuffer(cap.read_bytes(), np.uint8).reshape(-1, 2)
    assert raw.shape[0] >= 1024
    t = np.arange(raw.shape[0])
    want = np.stack([t, -t], axis=1).astype(np.int8)
    np.testing.assert_array_equal(raw, (want.astype(np.int16) + 128
                                        ).astype(np.uint8))

    # Through the device lifecycle: sample-type int8 routes to PulseAudio
    # and opens there.
    conf = tmp_path / "alsoft.conf"
    conf.write_text("sample-type = int8\ndrivers = pulse,alsa,null\n")
    monkeypatch.setenv("ALSOFT_CONF", str(conf))
    from openal_soft_tpu_torch.alc import config as alconf
    alconf.load_config(reload=True)
    try:
        dev = lifecycle.open_device(capacity=4, device="cpu")
        try:
            assert dev.name == lifecycle.PULSE_DEVICE_NAME
            assert dev.render.fmt_type == DevFmtType.BYTE
            assert isinstance(dev.backend, pulse.PulseBackend)
        finally:
            dev.close()
    finally:
        monkeypatch.delenv("ALSOFT_CONF")
        alconf.load_config(reload=True)


def test_pulse_capture_ring_stays_within_its_cap(fake_pulse, monkeypatch):
    """C4, pulse.py:219: a capture stream that is never read holds at most
    its requested buffer size, and keeps the newest frames."""
    from openal_soft_tpu_torch.alc import pulse

    _use_fake(monkeypatch, "OPENAL_TPU_PULSE_LIB", fake_pulse)
    monkeypatch.delenv("FAKE_PULSE_SOURCE", raising=False)
    cap = 3000
    backend = pulse.PulseCaptureBackend(None, RATE, "mono", buffer_frames=cap)
    reads = []
    inner = backend._lib

    class Counting:
        def __getattr__(self, name):
            return getattr(inner, name)

        def pa_simple_read(self, *args):
            reads.append(1)
            return inner.pa_simple_read(*args)

    backend._lib = Counting()
    backend.start()
    deadline = time.time() + 10.0
    while len(reads) < 40 and time.time() < deadline:
        assert backend.available() <= cap
        time.sleep(0.001)
    backend.stop()
    assert len(reads) >= 40             # 40 x 512 frames were produced
    assert backend.available() == cap
    got = backend.read(cap)[:, 0].astype(np.int64)
    backend.close()
    # The fake serves a frame-index ramp (mod 2**15): the ring holds the
    # last `cap` frames produced, in order.
    total = len(reads) * pulse.PulseCaptureBackend.CHUNK
    np.testing.assert_array_equal(got, np.arange(total - cap, total) & 0x7FFF)


def test_pulse_capture_close_waits_for_the_reader(fake_pulse, monkeypatch):
    """C4, pulse.py:228: close() while the reader is blocked in
    pa_simple_read leaves the stream alive; the reader frees it once its
    read returns, and never reads a freed stream."""
    from openal_soft_tpu_torch.alc import pulse

    _use_fake(monkeypatch, "OPENAL_TPU_PULSE_LIB", fake_pulse)
    backend = pulse.PulseCaptureBackend(None, RATE, "mono")
    inner = backend._lib
    in_read = threading.Event()
    release = threading.Event()
    log = []

    class Gated:
        def __getattr__(self, name):
            return getattr(inner, name)

        def pa_simple_read(self, s, *args):
            assert ("free", s.value) not in log
            log.append(("read", s.value))
            if len(log) == 3:
                in_read.set()
                release.wait(20.0)
            return inner.pa_simple_read(s, *args)

        def pa_simple_free(self, s):
            log.append(("free", ctypes.c_void_p(s).value
                        if not isinstance(s, ctypes.c_void_p) else s.value))
            return inner.pa_simple_free(s)

    backend._lib = Gated()
    stream = backend._stream.value
    backend.start()
    assert in_read.wait(10.0)
    t0 = time.time()
    backend.close()                       # the reader is inside a read
    assert time.time() - t0 < 5.0
    assert ("free", stream) not in log
    reader_alive = [t for t in threading.enumerate()
                    if t.name == "pulse-capture"]
    assert reader_alive
    release.set()
    for t in reader_alive:
        t.join(10.0)
    assert log[-1] == ("free", stream)
    assert log.count(("free", stream)) == 1
    assert not backend._stream


def test_pulse_capture_close_without_a_reader_frees_at_once(fake_pulse,
                                                            monkeypatch):
    from openal_soft_tpu_torch.alc import pulse

    _use_fake(monkeypatch, "OPENAL_TPU_PULSE_LIB", fake_pulse)
    backend = pulse.PulseCaptureBackend(None, RATE, "mono")
    backend.start()
    deadline = time.time() + 5.0
    while backend.available() < 512 and time.time() < deadline:
        time.sleep(0.001)
    backend.stop()
    backend.close()
    assert not backend._stream and not backend._reading
