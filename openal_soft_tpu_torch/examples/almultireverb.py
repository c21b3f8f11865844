"""Dual-zone reverb demo (port of examples/almultireverb.c).

Two auxiliary effect slots carry different reverb environments; a moving
source crossfades its sends between them by distance to each zone, the way
almultireverb.c balances its city/mountains zones.

    python -m openal_soft_tpu_torch.examples.almultireverb [-o out.wav] \
        [--device cuda|cpu]
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
    ap.add_argument("-o", "--out", default="multireverb.wav")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(frequency=RATE, capacity=16,
                                        num_aux_sends=2,
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    slots = []
    for preset in ("carpetedhallway", "bathroom"):
        slot = ctx.create_aux_slot()
        eff = ctx.create_effect("eaxreverb")
        for k, v in REVERB_PRESETS[preset].items():
            eff.set(k, v)
        slot.set_effect(eff)
        slots.append(slot)

    t = np.arange(RATE // 4) / RATE
    tone = (0.4 * np.sin(2 * np.pi * 320 * t)
            * np.exp(-6.0 * t)).astype(np.float32)
    buf = ctx.create_buffer()
    buf.set_data(tone, "mono", "float32", RATE)
    src = ctx.create_source()
    src.buffer(buf)
    src.looping = True
    src.send(slots[0], 0)
    src.send(slots[1], 1)
    src.play()

    # Move the source between the two zones, rebalancing the sends.
    frames_total = int(args.seconds * RATE)
    period = 4096
    out = []
    for i in range(0, frames_total, period):
        ph = i / frames_total
        xpos = np.cos(2 * np.pi * ph) * 4.0
        src.set("position", (float(xpos), 0.0, -2.0))
        d0 = abs(xpos + 4.0) + 1.0
        d1 = abs(xpos - 4.0) + 1.0
        g0 = d1 / (d0 + d1)
        sp0, sp1 = src.props.send[0], src.props.send[1]
        sp0.gain, sp1.gain = float(g0), float(1.0 - g0)
        src._props_dirty = True
        src.set("gain", src.props.gain)   # push the send change to the voice
        out.append(api.alcRenderSamplesSOFT(dev, period))
    data = np.concatenate(out)[:frames_total]
    _write_wav(args.out, data, RATE)
    print(f"wrote {args.out} ({args.seconds:.1f}s, two reverb zones)")


if __name__ == "__main__":
    main()
