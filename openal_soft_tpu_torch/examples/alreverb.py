"""EAXReverb demo (port of examples/alreverb.c).

Plays a percussive tone through an auxiliary reverb slot loaded with a
named EFX preset and writes the wet render to a WAV file.

    python -m openal_soft_tpu_torch.examples.alreverb [-p PRESET] \
        [-o out.wav] [-s SECONDS] [--device cuda|cpu]
    python -m openal_soft_tpu_torch.examples.alreverb --list  # 113 presets
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api
from ..al.presets import REVERB_PRESETS
from .altonegen import _write_wav

RATE = 48000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-p", "--preset", default="castle_hall")
    ap.add_argument("-o", "--out", default="reverb.wav")
    ap.add_argument("-s", "--seconds", type=float, default=3.0)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(sorted(REVERB_PRESETS)))
        return

    dev = api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    # percussive source: a decaying 220 Hz burst
    t = np.arange(RATE // 4) / RATE
    burst = (0.6 * np.sin(2 * np.pi * 220 * t)
             * np.exp(-t * 18.0)).astype(np.float32)
    buf = ctx_buf = api.alGenBuffers(1)
    api.alBufferData(buf, api.AL_FORMAT_MONO_FLOAT32, burst, RATE)

    eff = api.alGenEffects(1)
    slot = api.alGenAuxiliaryEffectSlots(1)
    context = api.alcGetCurrentContext()
    effect = context.effects[eff]
    effect.set_type("eaxreverb")
    effect.load_preset(REVERB_PRESETS[args.preset])
    context.aux_slots[slot].set_effect(effect)

    src = api.alGenSources(1)
    api.alSourcei(src, api.AL_BUFFER, ctx_buf)
    api.alSource3i(src, api.AL_AUXILIARY_SEND_FILTER, slot, 0, 0)
    api.alSourcePlay(src)

    out = api.alcRenderSamplesSOFT(dev, int(RATE * args.seconds))  # + tail
    _write_wav(args.out, out, RATE)
    print(f"preset {args.preset!r} -> {args.out} "
          f"(tail peak {np.abs(out[len(out) // 3:]).max():.4f})")


if __name__ == "__main__":
    main()
