"""Binaural HRTF demo (port of examples/alhrtf.c).

A mono source circles the listener while rendering through the default
HRTF data set; the binaural result goes to a WAV file.

    python -m openal_soft_tpu_torch.examples.alhrtf [-s SECONDS] \
        [-o out.wav] [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api
from .altonegen import _write_wav

RATE = 48000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-s", "--seconds", type=float, default=4.0)
    ap.add_argument("-o", "--out", default="hrtf.wav")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32", hrtf=True,
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    t = np.arange(RATE) / RATE
    tone = (0.35 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    buf = api.alGenBuffers(1)
    api.alBufferData(buf, api.AL_FORMAT_MONO_FLOAT32, tone, RATE)
    src = api.alGenSources(1)
    api.alSourcei(src, api.AL_BUFFER, buf)
    api.alSourcei(src, api.AL_LOOPING, 1)
    api.alSourcePlay(src)

    # circle once per 2 seconds, updating 20x/s like the C example's loop
    chunks = []
    step_frames = RATE // 20
    n_steps = int(args.seconds * 20)
    for i in range(n_steps):
        ang = 2.0 * np.pi * (i / 40.0)
        api.alSource3f(src, api.AL_POSITION,
                       float(np.sin(ang)), 0.0, float(-np.cos(ang)))
        chunks.append(api.alcRenderSamplesSOFT(dev, step_frames))
    out = np.concatenate(chunks)
    _write_wav(args.out, out, RATE)
    print(f"circling HRTF source -> {args.out} ({out.shape[0]} frames)")


if __name__ == "__main__":
    main()
