"""The effects' per-sample recurrences: plain versions and the Hopper
kernel's wrappers.

No TPU kernel stands behind these: the JAX package runs them as
``lax.scan`` (``effects/compressor.py``'s envelope, ``effects/autowah.py``'s
envelope follower and swept peaking filter).  The plain versions below are
per-sample torch loops in the JAX package's operand order; the kernels in
``csrc/effect_scan.cu`` repeat their arithmetic with every operation
rounded on its own and equal them bit for bit.

* ``compressor_env``: amp [B, T] (|wet0| clipped to [0.5, 2], or 1 when
  the compressor is off), env [B], prm [2] = (attack, release multipliers)
  -> (gains [B, T] = 1/env, env' [B]).
* ``autowah_env``: x [B, T], env [B], prm [3] = (peak gain, attack,
  release) -> (envs [B, T], env' [B]).
* ``swept_tdf2``: x [B, T], cf [5, T] per-sample normalised coefficients
  (b0, b1, b2, a1, a2) shared by every line, z [B, 2] -> (y [B, T],
  z' [B, 2]).  The caller computes the coefficients in torch, so that the
  transcendental functions run in one library for the kernel and for its
  plain version.

The wrappers take CPU tensors to the plain versions and CUDA tensors to
the kernel; on the card there is no fallback: the kernel launches or the
wrapper raises.  Each wrapper's ``.launches`` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_tensor, load_library


# --- plain versions -----------------------------------------------------------


def compressor_env_ref(amp: torch.Tensor, env: torch.Tensor,
                       prm: torch.Tensor):
    am, rm = prm[0], prm[1]
    gains = []
    for a in amp.T.unbind(0):
        env = torch.where(a > env, torch.minimum(env * am, a),
                          torch.where(a < env, torch.maximum(env * rm, a),
                                      env))
        gains.append(1.0 / env)
    return torch.stack(gains, 1), env


def autowah_env_ref(x: torch.Tensor, env: torch.Tensor, prm: torch.Tensor):
    pk, att, rel = prm[0], prm[1], prm[2]
    envs = []
    for xn in x.T.unbind(0):
        s = pk * xn.abs()
        env = s + (env - s) * torch.where(s > env, att, rel)
        envs.append(env)
    return torch.stack(envs, 1), env


def swept_tdf2_ref(x: torch.Tensor, cf: torch.Tensor, z: torch.Tensor):
    z0, z1 = z[:, 0], z[:, 1]
    cols = [row.unbind(0) for row in cf]
    ys = []
    for t, xn in enumerate(x.T.unbind(0)):
        b0, b1, b2, a1, a2 = (c[t] for c in cols)
        y = xn * b0 + z0
        z0 = xn * b1 - y * a1 + z1
        z1 = xn * b2 - y * a2
        ys.append(y)
    return torch.stack(ys, 1), torch.stack([z0, z1], 1)


# --- wrappers -----------------------------------------------------------------


def _launch(wrapper, ptrs: list, B: int, T: int, dev) -> None:
    entry = wrapper.__name__
    fn = getattr(load_library("effect_scan"), f"{entry}_launch")
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, T, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"effect_scan {entry} launch failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1


def _check_lines(name: str, x: torch.Tensor) -> tuple[int, int]:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: expected [B, T] with B, T >= 1, got "
                         f"{tuple(x.shape)}")
    check_tensor(name, x, torch.float32, tuple(x.shape), x.device)
    return x.shape


def _envelope(wrapper, ref, n_prm: int, x: torch.Tensor,
              env: torch.Tensor, prm: torch.Tensor):
    B, T = _check_lines(wrapper.__name__, x)
    check_tensor("env", env, torch.float32, (B,), x.device)
    check_tensor("prm", prm, torch.float32, (n_prm,), x.device)
    if x.device.type == "cpu":
        return ref(x, env, prm)
    out = torch.empty_like(x)
    env2 = torch.empty_like(env)
    _launch(wrapper, [x.data_ptr(), env.data_ptr(), prm.data_ptr(),
                      out.data_ptr(), env2.data_ptr()], B, T, x.device)
    return out, env2


def compressor_env(amp: torch.Tensor, env: torch.Tensor, prm: torch.Tensor):
    """The compressor's envelope over amp [B, T] from env [B]; prm [2].
    Returns (gains [B, T], env' [B])."""
    return _envelope(compressor_env, compressor_env_ref, 2, amp, env, prm)


def autowah_env(x: torch.Tensor, env: torch.Tensor, prm: torch.Tensor):
    """The autowah's envelope follower over x [B, T] from env [B]; prm [3].
    Returns (envs [B, T], env' [B])."""
    return _envelope(autowah_env, autowah_env_ref, 3, x, env, prm)


def swept_tdf2(x: torch.Tensor, cf: torch.Tensor, z: torch.Tensor):
    """One TDF2 biquad per line of x [B, T] with per-sample coefficients
    cf [5, T] shared by the lines, from state z [B, 2].
    Returns (y [B, T], z' [B, 2])."""
    B, T = _check_lines("swept_tdf2", x)
    check_tensor("cf", cf, torch.float32, (5, T), x.device)
    check_tensor("z", z, torch.float32, (B, 2), x.device)
    if x.device.type == "cpu":
        return swept_tdf2_ref(x, cf, z)
    y = torch.empty_like(x)
    z2 = torch.empty_like(z)
    _launch(swept_tdf2, [x.data_ptr(), cf.data_ptr(), z.data_ptr(),
                         y.data_ptr(), z2.data_ptr()], B, T, x.device)
    return y, z2


compressor_env.launches = 0
autowah_env.launches = 0
swept_tdf2.launches = 0
ENTRIES = (compressor_env, autowah_env, swept_tdf2)


def launches() -> int:
    """The kernel's launches through all three entries."""
    return sum(fn.launches for fn in ENTRIES)


def reset_launches() -> None:
    for fn in ENTRIES:
        fn.launches = 0
