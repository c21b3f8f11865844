"""Debug-extension demo (port of examples/aldebug.cpp).

Exercises AL_EXT_debug: reads the message log, installs a callback,
filters low-severity messages, pushes/pops a debug group, inserts an
application marker, and labels objects.

    python -m openal_soft_tpu_torch.examples.aldebug [--device cuda|cpu]
"""

import argparse

import numpy as np

from . import DEVICE_HELP
from ..al import api, debug as dbg

RATE = 48000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    dev = api.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    print("Enabling debug output...")
    api.alEnable(dbg.AL_DEBUG_OUTPUT_EXT)

    # Drain whatever startup messages are in the log (aldebug.cpp:196-230).
    for src, mtype, mid, sev, msg in api.alGetDebugMessageLogEXT(64):
        print(f"  log: src={src:#x} type={mtype:#x} id={mid} "
              f"sev={sev:#x} {msg!r}")

    # Filter out low-severity messages (aldebug.cpp:170-173).
    api.alDebugMessageControlEXT(dbg.AL_DONT_CARE_EXT, dbg.AL_DONT_CARE_EXT,
                                 dbg.AL_DEBUG_SEVERITY_LOW_EXT, None, False)

    print("Installing a debug callback...")

    def callback(source, mtype, mid, severity, message, user):
        print(f"  callback: src={source:#x} type={mtype:#x} id={mid} "
              f"sev={severity:#x} {message!r}")

    api.alDebugMessageCallbackEXT(callback)

    # Generate some activity inside a labeled debug group.
    api.alPushDebugGroupEXT(dbg.AL_DEBUG_SOURCE_APPLICATION_EXT, 1,
                            "example group")
    buf = api.alGenBuffers(1)
    api.alObjectLabelEXT("buffer", buf, "demo tone")
    tone = (0.2 * np.sin(2 * np.pi * 440.0
                         * np.arange(RATE // 4) / RATE)).astype(np.float32)
    api.alBufferData(buf, api.AL_FORMAT_MONO_FLOAT32, tone, RATE)
    print("buffer label:", api.alGetObjectLabelEXT("buffer", buf))
    api.alPopDebugGroupEXT()

    # Insert a custom marker, then unset the callback (aldebug.cpp:281-287).
    api.alDebugMessageInsertEXT(dbg.AL_DEBUG_SOURCE_APPLICATION_EXT,
                                dbg.AL_DEBUG_TYPE_MARKER_EXT, 0,
                                dbg.AL_DEBUG_SEVERITY_NOTIFICATION_EXT,
                                "End of run, bye!")
    api.alDebugMessageCallbackEXT(None)
    for src, mtype, mid, sev, msg in api.alGetDebugMessageLogEXT(64):
        print(f"  remaining: {msg!r}")

    api.alcMakeContextCurrent(None)
    api.alcCloseDevice(dev)
    print("done")


if __name__ == "__main__":
    main()
