"""The band splitter: the Hopper kernel's wrapper beside its plain
versions.

No TPU kernel stands behind it: the JAX package runs the splitter as
``lax.scan`` (``band_split``, ``band_split_hf_scale``,
``band_split_scale``) or as ``BandSplitterKernels``' chain of chunk steps.
The plain versions are the port's sequential ``ops/filters.py``
``band_split``, ``band_split_hf_scale`` and ``band_split_scale``; the
kernel in ``csrc/band_split.cu`` repeats their arithmetic with every
operation rounded on its own and equals them bit for bit.

``band_split(x, state, coeff, mode, hf, lf, variant_3arg)``: x [D, T] with
T a positive multiple of 32, state [D, 3] = (lp_z1, lp_z2, ap_z1), the
splitter's all-pass coefficient; mode ``"split"`` returns (hp, lp,
state'), ``"hf_scale"`` (hp*hf + lp, state') and ``"scale"`` (hp*hf +
lp*lf, state'), with the gains float32 tensors of one value or one per row
on x's device.  CPU tensors go to the plain versions, CUDA tensors to the
kernel; on the card there is no fallback: the kernel launches or the
wrapper raises.  ``band_split.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import filters as f_ops
from ._build import check_tensor, load_library

MODES = ("split", "hf_scale", "scale")
STEP = 32


def band_split_ref(x: torch.Tensor, state: torch.Tensor, coeff: float,
                   mode: str, hf: Optional[torch.Tensor] = None,
                   lf: Optional[torch.Tensor] = None,
                   variant_3arg: bool = False):
    """The plain version of ``band_split``, mode by mode."""
    if mode == "split":
        return f_ops.band_split(x, state, coeff, variant_3arg)
    if mode == "hf_scale":
        return f_ops.band_split_hf_scale(x, state, coeff, hf, variant_3arg)
    return f_ops.band_split_scale(x, state, coeff, hf, lf, variant_3arg)


@functools.cache
def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    fn = load_library("band_split").band_split_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _gain(name: str, g: Optional[torch.Tensor], D: int, device):
    """(the gain as a flat tensor, its row stride): one value (stride 0)
    or one per row."""
    if not isinstance(g, torch.Tensor):
        raise TypeError(f"band_split: {name} must be a tensor, got "
                        f"{type(g).__name__}")
    flat = g.reshape(-1)
    if flat.numel() not in (1, D):
        raise ValueError(f"band_split: {name} has {flat.numel()} values, "
                         f"expected 1 or {D}")
    check_tensor(name, flat, torch.float32, tuple(flat.shape), device)
    return flat, (0 if flat.numel() == 1 else 1)


def band_split(x: torch.Tensor, state: torch.Tensor, coeff: float,
               mode: str, hf: Optional[torch.Tensor] = None,
               lf: Optional[torch.Tensor] = None,
               variant_3arg: bool = False):
    """The band splitter over x [D, T] from state [D, 3] (see the module's
    docstring).  Returns (hp, lp, state') for ``"split"``, else (y,
    state')."""
    if mode not in MODES:
        raise ValueError(f"band_split: mode {mode!r} is not one of {MODES}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"band_split: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or x.shape[1] % STEP:
        raise ValueError(f"band_split: x must be [D, T] with D >= 1 and T a "
                         f"positive multiple of {STEP}, got "
                         f"{tuple(x.shape)}")
    D, T = x.shape
    check_tensor("x", x, torch.float32, (D, T), x.device)
    check_tensor("state", state, torch.float32, (D, 3), x.device)
    gains = [_gain("hf", hf, D, x.device) if mode != "split" else None,
             _gain("lf", lf, D, x.device) if mode == "scale" else None]
    if x.device.type == "cpu":
        return band_split_ref(x, state, coeff, mode, hf, lf, variant_3arg)
    if x.data_ptr() % 16:
        raise ValueError("band_split: x is not 16-byte aligned")
    y0 = torch.empty_like(x)
    y1 = torch.empty_like(x) if mode == "split" else None
    st2 = torch.empty_like(state)
    ptr = lambda g: (g[0].data_ptr(), g[1]) if g is not None else (0, 0)  # noqa: E731
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), state.data_ptr(), float(coeff), *ptr(gains[0]),
            *ptr(gains[1]), y0.data_ptr(),
            0 if y1 is None else y1.data_ptr(), st2.data_ptr(), D, T,
            MODES.index(mode), int(variant_3arg),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_split launch failed: CUDA error {err}")
    band_split.launches += 1
    return (y0, y1, st2) if mode == "split" else (y0, st2)


band_split.launches = 0
