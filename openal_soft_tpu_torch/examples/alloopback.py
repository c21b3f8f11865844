"""Loopback render demo (port of examples/alloopback.c).

Renders a scene through the loopback device at an arbitrary channel
format/sample type and writes the raw result — the reference's pattern for
driving OpenAL without an OS audio backend.

    python -m openal_soft_tpu_torch.examples.alloopback \
        [-c stereo|quad|surround51|ambi3d] [-t float32|int16] [-o out.wav] \
        [-s SECONDS] [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api
from .altonegen import _write_wav

RATE = 48000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--channels", default="stereo")
    ap.add_argument("-t", "--type", default="float32")
    ap.add_argument("-o", "--out", default="loopback.wav")
    ap.add_argument("-s", "--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(RATE, args.channels, args.type,
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    rng = np.random.default_rng(5)
    for i in range(4):
        t = np.arange(RATE // 2) / RATE
        freq = 220.0 * (i + 1)
        tone = (0.2 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        buf = api.alGenBuffers(1)
        api.alBufferData(buf, api.AL_FORMAT_MONO_FLOAT32, tone, RATE)
        src = api.alGenSources(1)
        api.alSourcei(src, api.AL_BUFFER, buf)
        api.alSourcei(src, api.AL_LOOPING, 1)
        api.alSource3f(src, api.AL_POSITION,
                       *(rng.standard_normal(3) * 2.0))
        api.alSourcePlay(src)

    out = api.alcRenderSamplesSOFT(dev, int(RATE * args.seconds))
    f32out = (out.astype(np.float32) / 32768.0 if args.type == "int16"
              else out.astype(np.float32))
    _write_wav(args.out, f32out, RATE)
    print(f"{args.channels}/{args.type} loopback -> {args.out} "
          f"{out.shape}")


if __name__ == "__main__":
    main()
