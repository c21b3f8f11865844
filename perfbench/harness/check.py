"""The comparison that decides ``correct``: the numbers compared, each
beside its limit from ``checks/<cell>.json``.

Each gap is the largest sample difference between the program's output of
one call and the reference's render of the same frames, over the
reference's peak in them:

- ``first_gap``: call 0, the start from nothing;
- ``out_gap``: call k, a call of the window drawn from the seed;
- ``last_gap``: the window's last call;
- ``failed``: calls of the window whose output was not finite or not of
  the cell's shape (limit 0).
"""

from __future__ import annotations

import numpy as np

TINY = 1e-30


def out_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return float("inf")
    return float(np.abs(prog - ref).max() / max(np.abs(ref).max(), TINY))


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when none exceeds it."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
