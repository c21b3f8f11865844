"""Source latency/clock query demo (port of examples/allatency.c).

Plays a tone and periodically prints AL_SAMPLE_OFFSET_LATENCY_SOFT /
AL_SEC_OFFSET_LATENCY_SOFT (AL_SOFT_source_latency) and the device clock
(ALC_SOFT_device_clock), showing the offset advancing block by block.

    python -m openal_soft_tpu_torch.examples.allatency [--seconds N] \
        [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api

RATE = 48000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(frequency=RATE, capacity=8,
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    t = np.arange(RATE) / RATE
    buf = ctx.create_buffer()
    buf.set_data((0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
                 "mono", "float32", RATE)
    sid = api.alGenSources(1)
    api.alSourcei(sid, 0x1009, buf.id)     # AL_BUFFER
    api.alSourcei(sid, 0x1007, 1)          # AL_LOOPING
    api.alSourcePlay(sid)

    total = int(args.seconds * RATE)
    period = 4800
    for i in range(0, total, period):
        api.alcRenderSamplesSOFT(dev, period)
        off_fixed, lat_ns = api.alGetSourcei64vSOFT(
            sid, api.AL_SAMPLE_OFFSET_LATENCY_SOFT)
        off_sec, lat_sec = api.alGetSourcedvSOFT(
            sid, api.AL_SEC_OFFSET_LATENCY_SOFT)
        clock, dev_lat = api.alcGetInteger64vSOFT(
            dev, api.ALC_DEVICE_CLOCK_LATENCY_SOFT)
        print(f"t={clock / 1e9:6.3f}s  offset {off_fixed >> 32:6d} samples "
              f"({off_sec:6.3f}s)  latency {lat_ns / 1e6:.2f} ms "
              f"(dev {dev_lat / 1e6:.2f} ms)")


if __name__ == "__main__":
    main()
