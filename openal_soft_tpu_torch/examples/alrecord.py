"""Capture demo (port of examples/alrecord.c).

Records from a capture device (a WAV file or synthetic tone acting as the
microphone stream) at a requested rate/format and writes the captured
samples to a WAV file — exercising the SampleConverter path.  Capture and
conversion run on the host; ``--device`` is checked like every example's
(``cuda`` raises without a card) and the OS capture device is
``--capture-device``.

    python -m openal_soft_tpu_torch.examples.alrecord [-i mic.wav] [-r RATE] \
        [-o out.wav] [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from .._device import resolve_device
from ..al import api
from ..alc.capture import ArrayCaptureBackend, WavCaptureBackend
from .altonegen import _write_wav


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", default=None,
                    help="WAV file to use as the microphone stream")
    ap.add_argument("--capture-device", default=None,
                    help="OS capture device name (ALSA PCM); records from "
                         "the real microphone when libasound is available")
    ap.add_argument("-r", "--rate", type=int, default=44100)
    ap.add_argument("-s", "--seconds", type=float, default=2.0)
    ap.add_argument("-o", "--out", default="record.wav")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    want = int(args.rate * args.seconds)
    backend = None
    if args.capture_device is not None:
        # Real OS capture (ALSA record loop -> converter -> ring).
        dev = api.alcCaptureOpenDeviceByName(args.capture_device, args.rate,
                                             api.AL_FORMAT_MONO16, want)
    else:
        if args.input:
            backend = WavCaptureBackend(args.input)
        else:
            t = np.arange(48000 * 4) / 48000
            sig = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
            backend = ArrayCaptureBackend(sig, 48000, "float32", "mono")
        dev = api.alcCaptureOpenDevice(backend, args.rate,
                                       api.AL_FORMAT_MONO16, want)
    api.alcCaptureStart(dev)
    if args.capture_device is not None:
        import time
        while dev.available_samples() < want:   # real capture fills in time
            time.sleep(0.05)
    n = min(dev.available_samples(), want)
    data = api.alcCaptureSamples(dev, n)
    api.alcCaptureStop(dev)
    api.alcCaptureCloseDevice(dev)

    _write_wav(args.out, data.astype(np.float32) / 32768.0, args.rate)
    source = (f"{backend.native_rate} Hz source" if backend is not None
              else args.capture_device)
    print(f"captured {n} frames at {args.rate} Hz ({source}) -> {args.out}")


if __name__ == "__main__":
    main()
