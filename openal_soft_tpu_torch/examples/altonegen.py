"""Tone generator (port of examples/altonegen.c).

Generates additive sine/square/sawtooth/impulse waveforms and plays them
through a loopback device, writing the result to a WAV file.

    python -m openal_soft_tpu_torch.examples.altonegen \
        [-t sine|square|sawtooth|triangle|impulse] [-f FREQ] [-s SECONDS] \
        [-o out.wav] [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api

RATE = 48000


def gen_wave(kind: str, freq: float, seconds: float) -> np.ndarray:
    """ApplySin additive synthesis (altonegen.c:61-120): harmonics are
    summed below nyquist so the classic shapes stay band-limited."""
    n = int(RATE * seconds)
    t = np.arange(n) / RATE
    data = np.zeros(n, np.float64)

    def add(gain, mult):
        data.__iadd__(gain * np.sin(2 * np.pi * freq * mult * t))

    if kind == "sine":
        add(1.0, 1)
    elif kind == "square":
        for h in range(1, int(RATE / 2 / freq), 2):
            add(4.0 / np.pi * 1.0 / h, h)
    elif kind == "sawtooth":
        for h in range(1, int(RATE / 2 / freq)):
            add(2.0 / np.pi * ((-1.0) ** h) / h, h)
    elif kind == "triangle":
        for h in range(1, int(RATE / 2 / freq), 2):
            add(8.0 / (np.pi * np.pi) * ((-1.0) ** ((h - 1) // 2)) / (h * h), h)
    elif kind == "impulse":
        data[:: RATE // int(freq)] = 1.0
    else:
        raise SystemExit(f"unknown wave type {kind}")
    peak = np.abs(data).max() or 1.0
    return (data / peak * 0.5).astype(np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", "--type", default="sine")
    ap.add_argument("-f", "--freq", type=float, default=440.0)
    ap.add_argument("-s", "--seconds", type=float, default=2.0)
    ap.add_argument("-o", "--out", default="tone.wav")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    buf = api.alGenBuffers(1)
    api.alBufferData(buf, api.AL_FORMAT_MONO_FLOAT32,
                     gen_wave(args.type, args.freq, args.seconds), RATE)
    src = api.alGenSources(1)
    api.alSourcei(src, api.AL_BUFFER, buf)
    api.alSourcePlay(src)

    out = api.alcRenderSamplesSOFT(dev, int(RATE * args.seconds))
    _write_wav(args.out, out, RATE)
    print(f"{args.type} {args.freq:g} Hz -> {args.out} "
          f"({out.shape[0]} frames, peak {np.abs(out).max():.3f})")


def _write_wav(path: str, data: np.ndarray, rate: int) -> None:
    import struct

    pcm = np.clip(data * 32768.0, -32768, 32767).astype("<i2")
    with open(path, "wb") as fh:
        n = pcm.size * 2
        fh.write(b"RIFF" + struct.pack("<I", 36 + n) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, data.shape[1],
                                       rate, rate * data.shape[1] * 2,
                                       data.shape[1] * 2, 16))
        fh.write(b"data" + struct.pack("<I", n))
        fh.write(pcm.tobytes())


if __name__ == "__main__":
    main()
