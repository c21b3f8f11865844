"""Callback-buffer streaming demo (port of examples/alstreamcb.cpp).

Streams generated audio through AL_SOFT_callback_buffer: the renderer
pulls samples on demand from a Python callback instead of a pre-uploaded
buffer, ending the stream when the callback returns short.

    python -m openal_soft_tpu_torch.examples.alstreamcb [-o out.wav] \
        [--seconds N] [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api
from .altonegen import _write_wav

RATE = 48000
AL_FORMAT_MONO_FLOAT32 = 0x10010


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--out", default="streamcb.wav")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(frequency=RATE, capacity=8,
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    total = int(args.seconds * RATE)
    state = {"pos": 0}

    def pull(frames: int) -> np.ndarray:
        """Generate a rising chirp; return fewer frames at end-of-stream."""
        start = state["pos"]
        n = min(frames, total - start)
        if n <= 0:
            return np.zeros(0, np.float32)
        i = np.arange(start, start + n)
        f0, f1 = 220.0, 880.0
        phase = 2 * np.pi * (f0 * i / RATE
                             + (f1 - f0) * i * i / (2 * RATE * total))
        state["pos"] = start + n
        return (0.35 * np.sin(phase)).astype(np.float32)

    bid = api.alGenBuffers(1)
    api.alBufferCallbackSOFT(bid, AL_FORMAT_MONO_FLOAT32, RATE, pull)
    sid = api.alGenSources(1)
    api.alSourcei(sid, 0x1009, bid)   # AL_BUFFER
    api.alSourcePlay(sid)

    out = []
    rendered = 0
    while api.alGetSourcei(sid, 0x1010) == 0x1012:   # AL_SOURCE_STATE PLAYING
        out.append(api.alcRenderSamplesSOFT(dev, 4096))
        rendered += 4096
        if rendered > total + 10 * RATE:
            break
    data = np.concatenate(out)
    _write_wav(args.out, data, RATE)
    print(f"wrote {args.out}: streamed {state['pos']} frames via callback, "
          f"rendered {rendered}")


if __name__ == "__main__":
    main()
