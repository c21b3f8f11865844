"""WAV playback (port of examples/alplay.c).

Loads a WAV file into a buffer and renders it through the device (loopback
by default; --wave writes via the timed wave-writer backend instead).

    python -m openal_soft_tpu_torch.examples.alplay input.wav [-o out.wav] \
        [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api
from ..alc.capture import _read_wav
from .altonegen import _write_wav

RATE = 48000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("-o", "--out", default="play.wav")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    in_rate, styp, chans, arr = _read_wav(args.input)
    fmt = {("mono", "int16"): api.AL_FORMAT_MONO16,
           ("stereo", "int16"): api.AL_FORMAT_STEREO16,
           ("mono", "float32"): api.AL_FORMAT_MONO_FLOAT32,
           ("stereo", "float32"): api.AL_FORMAT_STEREO_FLOAT32,
           ("mono", "uint8"): api.AL_FORMAT_MONO8,
           ("stereo", "uint8"): api.AL_FORMAT_STEREO8}[(chans, styp)]

    dev = api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    buf = api.alGenBuffers(1)
    api.alBufferData(buf, fmt, arr.reshape(-1), in_rate)
    src = api.alGenSources(1)
    api.alSourcei(src, api.AL_BUFFER, buf)
    api.alSourcePlay(src)

    frames = int(arr.shape[0] * RATE / in_rate) + RATE // 10
    out = api.alcRenderSamplesSOFT(dev, frames)
    _write_wav(args.out, out, RATE)
    state = api.alGetSourcei(src, api.AL_SOURCE_STATE)
    print(f"played {args.input} ({chans}/{styp}@{in_rate}) -> {args.out}; "
          f"final state {'stopped' if state == api.AL_STOPPED else state}")


if __name__ == "__main__":
    main()
