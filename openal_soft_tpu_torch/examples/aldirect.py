"""Direct-context demo (port of examples/aldirect.cpp).

Drives libopenal_torch.so's ALC_EXT_direct_context surface through ctypes:
every AL call takes the context explicitly (no thread-current context),
resolved via alcGetProcAddress2 like the reference example.  The library
is built at first use (native/build.py); ``--device`` reaches it as
``OPENAL_TORCH_DEVICE``, and ``--name`` picks the playback device (the
reference's ``-device``; the default route otherwise).

    python -m openal_soft_tpu_torch.examples.aldirect [--name NAME] \
        [--device cuda|cpu]
"""

import argparse
import ctypes as ct
import os
import time

from . import DEVICE_HELP
from ..native import build

AL_FORMAT_MONO16 = 0x1101
AL_BUFFER = 0x1009
AL_LOOPING = 0x1007
AL_SOURCE_STATE = 0x1010
AL_PLAYING = 0x1012


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default=None,
                    help="playback device name (default route if omitted)")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    os.environ["OPENAL_TORCH_DEVICE"] = args.device

    al = ct.CDLL(str(build.build_shim()))
    al.alcOpenDevice.argtypes = [ct.c_char_p]
    al.alcOpenDevice.restype = ct.c_void_p
    al.alcCreateContext.restype = ct.c_void_p
    al.alcGetProcAddress2.restype = ct.c_void_p
    al.alcGetProcAddress2.argtypes = [ct.c_void_p, ct.c_char_p]

    dev = al.alcOpenDevice(args.name.encode() if args.name else None)
    if not dev:
        raise SystemExit("alcOpenDevice failed")
    ctx = al.alcCreateContext(ct.c_void_p(dev), None)
    # NOTE: the current context is never set — everything below goes
    # through the *Direct variants with ctx passed explicitly.

    def proc(name, restype, *argtypes):
        addr = al.alcGetProcAddress2(ct.c_void_p(dev), name.encode())
        if not addr:
            raise SystemExit(f"missing {name}")
        return ct.CFUNCTYPE(restype, *argtypes)(addr)

    alGenBuffersDirect = proc("alGenBuffersDirect", None, ct.c_void_p,
                              ct.c_int, ct.POINTER(ct.c_uint))
    alBufferDataDirect = proc("alBufferDataDirect", None, ct.c_void_p,
                              ct.c_uint, ct.c_int, ct.c_void_p, ct.c_int,
                              ct.c_int)
    alGenSourcesDirect = proc("alGenSourcesDirect", None, ct.c_void_p,
                              ct.c_int, ct.POINTER(ct.c_uint))
    alSourceiDirect = proc("alSourceiDirect", None, ct.c_void_p, ct.c_uint,
                           ct.c_int, ct.c_int)
    alSourcePlayDirect = proc("alSourcePlayDirect", None, ct.c_void_p,
                              ct.c_uint)
    alGetSourceiDirect = proc("alGetSourceiDirect", None, ct.c_void_p,
                              ct.c_uint, ct.c_int, ct.POINTER(ct.c_int))
    alGetErrorDirect = proc("alGetErrorDirect", ct.c_int, ct.c_void_p)

    # A quarter-second 440 Hz tone as 16-bit mono.
    import math
    n = 48000 // 4
    samples = (ct.c_int16 * n)(*(
        int(0.4 * 32767 * math.sin(2 * math.pi * 440 * i / 48000))
        for i in range(n)))

    buf = ct.c_uint()
    alGenBuffersDirect(ctx, 1, ct.byref(buf))
    alBufferDataDirect(ctx, buf, AL_FORMAT_MONO16, samples,
                       ct.sizeof(samples), 48000)
    src = ct.c_uint()
    alGenSourcesDirect(ctx, 1, ct.byref(src))
    alSourceiDirect(ctx, src, AL_BUFFER, buf.value)
    alSourcePlayDirect(ctx, src)
    err = alGetErrorDirect(ctx)
    print(f"started source {src.value} on buffer {buf.value} "
          f"(error {err:#x})")

    state = ct.c_int()
    deadline = time.monotonic() + 60.0
    while True:
        alGetSourceiDirect(ctx, src, AL_SOURCE_STATE, ct.byref(state))
        if state.value != AL_PLAYING:
            break
        if time.monotonic() > deadline:
            raise SystemExit("the source still plays after 60 s")
        time.sleep(0.05)
    print("playback finished")

    al.alcDestroyContext(ct.c_void_p(ctx))
    al.alcCloseDevice(ct.c_void_p(dev))


if __name__ == "__main__":
    main()
