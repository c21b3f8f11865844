"""Interpolating biquad cascades: the Hopper kernel's wrappers beside their
plain versions.

The plain version is ``ops/filters.biquad_interp`` (sample-sequential TDF2
sections, the 32-sample coefficient lerp), re-exported here as
``biquad_dual_ref``; ``biquad_paths_ref`` applies it to several filter
paths over one input, with the active masks' selects written out.  The
wrappers take CPU tensors to these and CUDA tensors to the kernel in
``csrc/biquad.cu`` (which replaces the TPU kernel
``openal_soft_tpu/ops/pallas/biquad.py`` ``_kernel``); the two are equal
bit for bit.

* ``biquad_dual``: one path, every line active, state returned as new
  tensors; two sections (the voices' filters) or four (the UHJ codecs'
  all-pass cascades).
* ``biquad_paths``: up to 8 paths (``FilterPath``) that filter the same x,
  each with its own state, schedule and active mask, the state updated in
  place: the device's direct and aux-send filters in one launch.

On the card there is no fallback: the kernel launches or the wrapper
raises.  ``biquad_dual.launches`` counts the kernel's launches through
either wrapper.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .. import filters as f_ops
from ._build import check_tensor, load_library

MAX_PATHS = 8
SECTIONS = (2, 4)

biquad_dual_ref = f_ops.biquad_interp


class FilterPath(NamedTuple):
    """One filter path over the lines: z [V, S, 2], coeffs and target
    [V, S, 5] f32, counter [V] int32, active [V] bool or None (all).  Each
    may be a view with a line stride (a send of ``send_filter_z [V, sends,
    2, 2]``) whose per-line block is contiguous."""
    z: torch.Tensor
    coeffs: torch.Tensor
    target: torch.Tensor
    counter: torch.Tensor
    active: Optional[torch.Tensor] = None


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    fn = load_library("biquad").biquad_paths_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or x.shape[1] % 32:
        raise ValueError(f"{name}: x must be [V, T] with V >= 1 and T a "
                         f"positive multiple of 32, got {tuple(x.shape)}")
    check_tensor("x", x, torch.float32, tuple(x.shape), x.device)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x is not 16-byte aligned")


def _check_lines(name: str, t: torch.Tensor, dtype, shape: tuple,
                 device) -> int:
    """Raise unless t is a ``dtype`` tensor of ``shape`` on ``device``
    whose per-line block is contiguous and whose lines do not overlap;
    returns its line stride in elements."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    inner = 1
    for size, stride in zip(reversed(shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != inner:
            raise ValueError(f"{name}: each line's block is not contiguous")
        inner *= size
    if shape[0] > 1 and t.stride(0) < inner:
        raise ValueError(f"{name}: lines overlap (stride {t.stride(0)})")
    return t.stride(0)


def _launch(x: torch.Tensor, S: int, descs: list) -> None:
    V, T = x.shape
    desc = (ctypes.c_longlong * (14 * len(descs)))(
        *[int(v) for d in descs for v in d])
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(x.data_ptr(), V, T, S, len(descs),
                          ctypes.addressof(desc), stream)
    if err != 0:
        raise RuntimeError(f"biquad kernel launch failed: CUDA error {err}")
    biquad_dual.launches += 1


def biquad_dual(x: torch.Tensor, z: torch.Tensor, coeffs: torch.Tensor,
                target: torch.Tensor, counter: torch.Tensor):
    """Filter V lines through their S = 2 or 4 cascaded interpolating
    biquads.

    x [V, T] f32 with T % 32 == 0, 16-byte aligned (the kernel streams its
    rows in 128-byte steps); z [V, S, 2], coeffs and target [V, S, 5] f32;
    counter [V] int32 (>= 0).  All contiguous and on x's device.
    Returns (y [V, T], z' [V, S, 2], coeffs' [V, S, 5], counter' [V])."""
    _check_x("biquad_dual", x)
    V, T = x.shape
    dev = x.device
    S = z.shape[1] if z.dim() == 3 else 0
    if S not in SECTIONS:
        raise ValueError(f"biquad_dual: z must be [V, 2 or 4, 2], got "
                         f"{tuple(z.shape)}")
    check_tensor("z", z, torch.float32, (V, S, 2), dev)
    check_tensor("coeffs", coeffs, torch.float32, (V, S, 5), dev)
    check_tensor("target", target, torch.float32, (V, S, 5), dev)
    check_tensor("counter", counter, torch.int32, (V,), dev)
    if dev.type == "cpu":
        return biquad_dual_ref(x, z, coeffs, target, counter)
    y = torch.empty_like(x)
    z2 = torch.empty_like(z)
    cf2 = torch.empty_like(coeffs)
    cnt2 = torch.empty_like(counter)
    _launch(x, S, [(z.data_ptr(), z2.data_ptr(), 2 * S, coeffs.data_ptr(),
                    cf2.data_ptr(), 5 * S, target.data_ptr(), 5 * S,
                    counter.data_ptr(), cnt2.data_ptr(), 1, 0, 0,
                    y.data_ptr())])
    return y, z2, cf2, cnt2


biquad_dual.launches = 0


def chain_probe(n: int, device) -> tuple[int, int]:
    """(SM cycles, ns) one thread of the card takes for n samples of one
    section's loop-carried chain (the floor of a sample-sequential design),
    from ``csrc/biquad.cu``'s probe."""
    fn = load_library("biquad").biquad_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(3, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = fn(n, out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"biquad chain probe failed: CUDA error {err}")
    cycles, ns, _ = out.tolist()
    return cycles, ns


def biquad_paths_ref(x: torch.Tensor, paths: Sequence[FilterPath]):
    """Plain version of ``biquad_paths``: every path's lines stacked into
    one ``biquad_interp`` call, then each path's selects (the filtered line
    where active, x elsewhere; the state kept or cleared, the coefficients
    on target, the counter at 0 where inactive) written into its state."""
    V = x.shape[0]
    P = len(paths)
    y, z2, cf2, cnt2 = f_ops.biquad_interp(
        x.repeat(P, 1), torch.cat([p.z for p in paths]),
        torch.cat([p.coeffs for p in paths]),
        torch.cat([p.target for p in paths]),
        torch.cat([p.counter for p in paths]))
    out = []
    for i, p in enumerate(paths):
        lines = slice(i * V, (i + 1) * V)
        if p.active is None:
            p.z.copy_(z2[lines])
            p.coeffs.copy_(cf2[lines])
            p.counter.copy_(cnt2[lines])
            out.append(y[lines])
            continue
        fa = p.active
        p.z.copy_(torch.where(fa[:, None, None], z2[lines], 0.0))
        p.coeffs.copy_(torch.where(fa[:, None, None], cf2[lines], p.target))
        p.counter.copy_(torch.where(fa, cnt2[lines], 0))
        out.append(torch.where(fa[:, None], y[lines], x))
    return torch.stack(out)


def biquad_paths(x: torch.Tensor, paths: Sequence[FilterPath]):
    """Filter x [V, T] through 1..8 paths in one launch: returns y
    [P, V, T], each path's state updated in place (see ``FilterPath``).
    All paths have the same number of sections, 2 or 4; x as for
    ``biquad_dual``."""
    _check_x("biquad_paths", x)
    V, T = x.shape
    dev = x.device
    if not 1 <= len(paths) <= MAX_PATHS:
        raise ValueError(f"biquad_paths: 1..{MAX_PATHS} paths, got "
                         f"{len(paths)}")
    S = paths[0].z.shape[1] if paths[0].z.dim() == 3 else 0
    if S not in SECTIONS:
        raise ValueError(f"biquad_paths: z must be [V, 2 or 4, 2], got "
                         f"{tuple(paths[0].z.shape)}")
    descs = []
    for i, p in enumerate(paths):
        zs = _check_lines(f"path {i} z", p.z, torch.float32, (V, S, 2), dev)
        cs = _check_lines(f"path {i} coeffs", p.coeffs, torch.float32,
                          (V, S, 5), dev)
        ts = _check_lines(f"path {i} target", p.target, torch.float32,
                          (V, S, 5), dev)
        ns = _check_lines(f"path {i} counter", p.counter, torch.int32, (V,),
                          dev)
        fs = 0 if p.active is None else _check_lines(
            f"path {i} active", p.active, torch.bool, (V,), dev)
        descs.append([p.z.data_ptr(), p.z.data_ptr(), zs,
                      p.coeffs.data_ptr(), p.coeffs.data_ptr(), cs,
                      p.target.data_ptr(), ts, p.counter.data_ptr(),
                      p.counter.data_ptr(), ns,
                      0 if p.active is None else p.active.data_ptr(), fs])
    if dev.type == "cpu":
        return biquad_paths_ref(x, paths)
    y = torch.empty((len(paths), V, T), dtype=torch.float32, device=dev)
    for i, d in enumerate(descs):
        d.append(y[i].data_ptr())
    _launch(x, S, descs)
    return y
