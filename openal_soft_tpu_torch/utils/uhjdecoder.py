"""Offline UHJ file decoder (utils/uhjdecoder.cpp analog).

Decodes a 2/3/4-channel UHJ WAV into first-order B-Format (W, X, Y[, Z])
through the renderer's batched decoder (ops/uhj.py), FIR256/FIR512 tiers.

    python -m openal_soft_tpu_torch.utils.uhjdecoder in.wav out.wav \
        [--tier fir256|fir512] [--device cuda|cpu]

The decoder runs on the card (``--device cuda``, the default) unless the
CPU is asked for; the signal is uploaded once and the result comes back in
one copy.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..ops import uhj as uhj_ops
from .uhjencoder import _read_wav, _write_wav

BLOCK = 4096


def decode(data: np.ndarray, tier: str = "fir256",
           device: str | torch.device = "cuda") -> np.ndarray:
    """[frames, 2-4] UHJ float32 -> [frames, 3 or 4] B-Format on
    ``device``, in BLOCK-sample calls."""
    dev = resolve_device(device)
    n_in = data.shape[1]
    if n_in < 2 or n_in > 4:
        raise SystemExit(f"UHJ input needs 2-4 channels, got {n_in}")
    nfir = 512 if tier == "fir512" else 256
    pad = uhj_ops.fir_pad(nfir)
    hist = uhj_ops.fir_hist(nfir)
    n = data.shape[0]
    x = np.pad(data.T.astype(np.float32), ((0, 4 - n_in if n_in < 3 else 0),
                                           (0, pad + (-n) % BLOCK)))
    C = 4 if n_in >= 4 else 3
    x = torch.from_numpy(np.ascontiguousarray(x[:C])).to(dev)
    dt_hist = torch.zeros((1, hist), dtype=torch.float32, device=dev)
    s_hist = torch.zeros((1, hist), dtype=torch.float32, device=dev)
    outs = []
    for i in range(0, n + (-n) % BLOCK, BLOCK):
        chans = x[None, :, i:i + BLOCK + pad]
        dec, dt_hist, s_hist = uhj_ops.uhj_decode(
            chans, dt_hist, s_hist, BLOCK, n_in, nfir)
        outs.append(dec[0].T)
    return torch.cat(outs)[:n].cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--tier", default="fir256", choices=("fir256", "fir512"))
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    data, rate = _read_wav(args.infile)
    out = decode(data, args.tier, args.device)
    _write_wav(args.outfile, out, rate)
    print(f"wrote {args.outfile}: {out.shape[0]} frames B-Format "
          f"({out.shape[1]} ch, {args.tier})")


if __name__ == "__main__":
    main()
