"""Convolution reverb demo (port of examples/alconvolve.c).

Loads (or synthesizes) an impulse response into a buffer, attaches it to a
convolution-effect slot, and renders a dry source through it.

    python -m openal_soft_tpu_torch.examples.alconvolve [-i ir.wav] \
        [-o out.wav] [-s SECONDS] [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api
from .altonegen import _write_wav

RATE = 48000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--ir", default=None, help="impulse response WAV")
    ap.add_argument("-o", "--out", default="convolve.wav")
    ap.add_argument("-s", "--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)
    context = api.alcGetCurrentContext()

    if args.ir:
        from ..alc.capture import _read_wav

        ir_rate, styp, chans, arr = _read_wav(args.ir)
        ir = arr[:, 0].astype(np.float32)
        if styp != "float32":
            ir /= np.abs(ir).max() or 1.0
    else:
        # synthetic exponentially-decaying noise IR (~0.8 s)
        rng = np.random.default_rng(11)
        n = int(RATE * 0.8)
        ir = (rng.standard_normal(n)
              * np.exp(-np.arange(n) / (RATE * 0.15)) * 0.25
              ).astype(np.float32)
        ir_rate = RATE

    irbuf = context.create_buffer()
    irbuf.set_data(ir, "mono", "float32", ir_rate)
    eff = context.create_effect("convolution")
    eff.set("buffer", irbuf)
    slot = context.create_aux_slot()
    slot.set_effect(eff)

    t = np.arange(RATE // 4) / RATE
    click = (0.5 * np.sin(2 * np.pi * 500 * t)
             * np.exp(-t * 30.0)).astype(np.float32)
    buf = api.alGenBuffers(1)
    api.alBufferData(buf, api.AL_FORMAT_MONO_FLOAT32, click, RATE)
    src = api.alGenSources(1)
    api.alSourcei(src, api.AL_BUFFER, buf)
    api.alSource3i(src, api.AL_AUXILIARY_SEND_FILTER, slot.id, 0, 0)
    api.alSourcePlay(src)

    out = api.alcRenderSamplesSOFT(dev, int(RATE * args.seconds))
    _write_wav(args.out, out, RATE)
    print(f"convolved ({len(ir)} tap IR @ {ir_rate} Hz) -> {args.out}")


if __name__ == "__main__":
    main()
