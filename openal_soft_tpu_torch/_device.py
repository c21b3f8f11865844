"""Torch device resolution and float32 matmul precision.

The default is the card, ``"cuda"``; the CPU must be asked for with
``"cpu"``.  ``"cuda"`` without a usable card raises instead of quietly
running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device to render on: ``cpu`` or ``cuda[:n]``, never a guess.

    Also pins float32 contractions to full precision, process-wide and
    explicitly rather than by default: every JAX contraction on the ported
    path is ``Precision.HIGHEST``, and TF32 keeps about three digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but "
                "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "use 'cpu' or 'cuda'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev
