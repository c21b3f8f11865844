"""SOFA file inspector (utils/sofa-info.cpp analog).

Prints the file's attributes, dimensions (M/R/E/N), sample rate, and the
compatible az/elevation field layout the makemhr grid fitter would use
(sofa-info.cpp:82-150).

    python -m openal_soft_tpu_torch.utils.sofa_info file.sofa

It reads the file with h5py, imported when it runs: a host without h5py
cannot run it (the ImportError propagates).
"""

from __future__ import annotations

import sys


def main(argv=None) -> None:
    import h5py
    import numpy as np

    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        raise SystemExit(f"Usage: {sys.argv[0]} <sofa-file>")
    path = argv[0]

    with h5py.File(path, "r") as f:
        for k, v in f.attrs.items():
            val = v.decode() if isinstance(v, bytes) else v
            print(f"{k}: {val}")
        print()
        ir = f.get("Data.IR")
        if ir is None:
            raise SystemExit("no Data.IR variable")
        m, r, n = ir.shape
        print(f"Measurements: {m}")
        print(f"Receivers: {r}")
        emitters = f.get("EmitterPosition")
        print(f"Emitters: {emitters.shape[0] if emitters is not None else 1}")
        print(f"Samples: {n}")
        rate = f.get("Data.SamplingRate")
        if rate is not None:
            print(f"Sample rate: {int(np.asarray(rate).ravel()[0])}")
        delay = f.get("Data.Delay")
        if delay is not None:
            d = np.asarray(delay)
            print(f"Delay: shape {d.shape}, range "
                  f"{d.min():.3f}..{d.max():.3f}")
        pos = f.get("SourcePosition")
        if pos is None:
            return
        pos = np.asarray(pos)
        print()
        from .makemhr import load_sofa
        try:
            hset = load_sofa(path)
        except Exception as e:  # irregular grids: report, don't die
            print(f"No compatible field layout ({e})")
            return
        total = sum(sum(az) for _, az in hset.fields)
        print(f"Compatible Layout ({total} of {m} measurements):\n")
        print("distance = " + ", ".join(f"{d:.3f}" for d, _ in hset.fields))
        for d, az_counts in hset.fields:
            print(f"azimuths[{d:.3f}] = "
                  + ", ".join(str(a) for a in az_counts))


if __name__ == "__main__":
    main()
