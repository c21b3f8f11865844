"""Offline UHJ file encoder (utils/uhjencoder.cpp analog).

Transcodes a B-Format (WXY[Z], FuMa or ACN/N3D) or mono/stereo WAV into a
2-channel UHJ WAV through the same block-wise encoder the renderer uses
(ops/uhj.py UhjEncoderState / uhj_encode_iir), making it a cheap source of
golden vectors for the output codec.

    python -m openal_soft_tpu_torch.utils.uhjencoder in.wav out.wav \
        [--tier iir|fir256|fir512] [--device cuda|cpu]

Mono input is panned center; stereo is encoded as left/right front
(+-30 degrees), matching uhjencoder.cpp's default layout.  The encoder runs
on the card (``--device cuda``, the default) unless the CPU is asked for;
the ``iir`` tier's all-pass cascades run on the dual-biquad kernel there.
The signal is uploaded once, every block's output stays on the device, and
the whole result comes back in one copy.
"""

from __future__ import annotations

import argparse
import wave

import numpy as np
import torch

from .._device import resolve_device
from ..ops import uhj as uhj_ops

BLOCK = 4096


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as fh:
        n = fh.getnframes()
        ch = fh.getnchannels()
        width = fh.getsampwidth()
        rate = fh.getframerate()
        raw = fh.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise SystemExit(f"unsupported sample width {width}")
    return data.reshape(-1, ch), rate


def _write_wav(path: str, data: np.ndarray, rate: int) -> None:
    pcm = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as fh:
        fh.setnchannels(data.shape[1])
        fh.setsampwidth(2)
        fh.setframerate(rate)
        fh.writeframes(pcm.tobytes())


def _to_foa(data: np.ndarray) -> np.ndarray:
    """Input channels -> FuMa-scaled (W, X, Y) rows for the encoder."""
    ch = data.shape[1]
    if ch >= 3:
        # B-Format file: assume FuMa WXYZ ordering (the uhjencoder.cpp
        # default for .amb files); pass W/X/Y through.
        return data[:, :3].T.astype(np.float32)
    if ch == 1:
        m = data[:, 0]
        # center front: X = cos(0), Y = sin(0)
        return np.stack([m * np.sqrt(0.5), m, np.zeros_like(m)]).astype(np.float32)
    left, right = data[:, 0], data[:, 1]
    c30, s30 = np.cos(np.pi / 6), np.sin(np.pi / 6)
    w = (left + right) * np.sqrt(0.5)
    x = (left + right) * c30
    y = (left - right) * s30
    return np.stack([w, x, y]).astype(np.float32)


def encode(data: np.ndarray, tier: str = "iir",
           device: str | torch.device = "cuda") -> np.ndarray:
    """[frames, channels] float32 -> [frames, 2] UHJ, in BLOCK-sample
    calls of the renderer's encoder on ``device``."""
    dev = resolve_device(device)
    foa = _to_foa(data)
    n = foa.shape[1]
    pad = (-n) % BLOCK
    foa = torch.from_numpy(np.pad(foa, ((0, 0), (0, pad)))).to(dev)
    outs = []
    if tier == "iir":
        st = uhj_ops.uhj_encoder_iir_state(dev)
        for i in range(0, foa.shape[1], BLOCK):
            w, x, y = foa[:, i:i + BLOCK]
            left, right, st = uhj_ops.uhj_encode_iir(w, x, y, st, BLOCK)
            outs.append(torch.stack([left, right], 1))
    else:
        enc = uhj_ops.UhjEncoderState(512 if tier == "fir512" else 256)
        st = enc.init(dev)
        for i in range(0, foa.shape[1], BLOCK):
            w, x, y = foa[:, i:i + BLOCK]
            st, left, right = enc.encode(st, w, x, y, BLOCK)
            outs.append(torch.stack([left, right], 1))
    return torch.cat(outs)[:n].cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--tier", default="iir",
                    choices=("iir", "fir256", "fir512"))
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    data, rate = _read_wav(args.infile)
    out = encode(data, args.tier, args.device)
    _write_wav(args.outfile, out, rate)
    print(f"wrote {args.outfile}: {out.shape[0]} frames UHJ2 ({args.tier})")


if __name__ == "__main__":
    main()
