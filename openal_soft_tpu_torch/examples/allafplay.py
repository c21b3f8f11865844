"""Limitless Audio Format player (port of examples/allafplay.cpp).

Parses LAF ("LIMITLESS"/"HEAD" chunked) files and renders them through the
loopback device: Channels mode places each track at its fixed
elevation/azimuth (LFE tracks route through a dedicated-LFE effect slot);
Objects mode drives per-object positions from the trailing position tracks.

Because rendering is pull-based here, object positions update exactly every
48 frames (FramesPerPos) — the reference's "as fast as the app can react"
granularity caveat (allafplay.cpp:41-49) does not apply.

    python -m openal_soft_tpu_torch.examples.allafplay file.laf [-o out.wav] \
        [--device cuda|cpu]
"""

import argparse
import struct

import numpy as np

from . import DEVICE_HELP
from ..al import api
from .altonegen import _write_wav

FRAMES_PER_POS = 48
QUALITIES = {0: ("s8", 1), 1: ("s16", 2), 2: ("f32", 4), 3: ("s24", 3)}


class LafStream:
    def __init__(self, path: str) -> None:
        self.fh = open(path, "rb")
        if self.fh.read(9) != b"LIMITLESS":
            raise SystemExit("Not an LAF file")
        head = self.fh.read(10)
        while head[:4] != b"HEAD":     # scan for the HEAD marker
            pos = head.find(b"HEAD")
            keep = head[pos:] if pos >= 0 else b""
            head = keep + self.fh.read(10 - len(keep))
        self.quality, self.bps = QUALITIES[head[4]]
        self.mode = {0: "channels", 1: "objects"}[head[5]]
        self.n_tracks = struct.unpack("<I", head[6:10])[0]
        if not 0 < self.n_tracks <= 256:
            raise SystemExit(f"Bad track count {self.n_tracks}")

        chandata = self.fh.read(self.n_tracks * 9)
        if self.mode == "channels":
            n_chan, n_pos = self.n_tracks, 0
        else:
            n_chan, n_pos = self.n_tracks - 1, 1
            while n_pos * 16 < n_chan:
                n_chan -= 1
                n_pos += 1
        self.channels = []
        for i in range(n_chan):
            elev, azim = struct.unpack_from("<ff", chandata, i * 9)
            lfe = chandata[i * 9 + 8] != 0
            self.channels.append((elev, azim, lfe))
        self.n_pos = n_pos

        foot = self.fh.read(12)
        self.rate = struct.unpack("<I", foot[:4])[0]
        self.n_samples = struct.unpack("<Q", foot[4:])[0]
        if self.mode == "objects" and self.rate % FRAMES_PER_POS:
            raise SystemExit("Objects mode needs a rate divisible by 48")
        # Two seconds of decoded positions per track (current + next chunk).
        self.pos_tracks = [np.zeros(self.rate * 2, np.float32)
                           for _ in range(n_pos)]
        self.done = 0

    def _decode(self, raw: bytes, n: int) -> np.ndarray:
        if self.quality == "s8":
            return np.frombuffer(raw, np.int8, n).astype(np.float32) / 127.0
        if self.quality == "s16":
            return np.frombuffer(raw, "<i2", n).astype(np.float32) / 32767.0
        if self.quality == "f32":
            return np.frombuffer(raw, "<f4", n).astype(np.float32)
        b = np.frombuffer(raw, np.uint8)[: n * 3].reshape(n, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v = (v ^ 0x800000) - 0x800000
        return v.astype(np.float32) / 8388607.0

    def read_chunk(self):
        """One-second chunk: enable bitmask + interleaved enabled tracks.
        Returns ([n_chan arrays], frames) or (None, 0) at end."""
        nbytes = (self.n_tracks + 7) >> 3
        bits = self.fh.read(nbytes)
        if len(bits) < nbytes:
            self.n_samples = self.done
            return None, 0
        mask = int.from_bytes(bits, "little")
        enabled = [i for i in range(self.n_tracks) if mask >> i & 1]
        frames = min(self.rate, self.n_samples - self.done)
        raw = self.fh.read(frames * self.bps * len(enabled))
        frames = len(raw) // (self.bps * max(len(enabled), 1))
        self.done += frames

        out = [np.zeros(frames, np.float32) for _ in range(len(self.channels))]
        # Advance position history: last chunk's positions move to the front.
        for p in self.pos_tracks:
            p[: self.rate] = p[self.rate:]
        # Samples are frame-interleaved across the enabled tracks
        # (allafplay.cpp:417-447 prepareTrack): decode the whole chunk and
        # deinterleave by stride.
        all_samples = self._decode(raw, frames * len(enabled))
        for slot, track in enumerate(enabled):
            seg = np.ascontiguousarray(all_samples[slot::len(enabled)])
            if track < len(self.channels):
                out[track] = seg
            else:
                pt = track - len(self.channels)
                self.pos_tracks[pt][self.rate: self.rate + frames] = seg
        return out, frames

    def object_position(self, obj: int, frame: int):
        """Object position at an absolute frame within the current 2-chunk
        position window (allafplay.cpp:984-1002)."""
        track = obj >> 4
        po = (frame // FRAMES_PER_POS) * 16 + (obj & 15)
        p = self.pos_tracks[track]
        x, y, z = p[po * 3], p[po * 3 + 1], p[po * 3 + 2]
        return float(x), float(y), float(-z)   # left- to right-handed


def write_laf(path: str, tracks: np.ndarray, rate: int, layout) -> None:
    """A Channels-mode float32 LAF file, the layout LafStream reads:
    ``tracks`` [n_tracks, frames] float32, ``layout`` one (elevation_deg,
    azimuth_deg, lfe) per track; every one-second chunk has every track
    enabled."""
    n, frames = tracks.shape
    with open(path, "wb") as fh:
        fh.write(b"LIMITLESS" + b"HEAD" + bytes([2, 0])
                 + struct.pack("<I", n))
        for elev, azim, lfe in layout:
            fh.write(struct.pack("<ff", elev, azim) + bytes([int(lfe)]))
        fh.write(struct.pack("<IQ", rate, frames))
        for i in range(0, frames, rate):
            fh.write(((1 << n) - 1).to_bytes((n + 7) >> 3, "little"))
            fh.write(np.ascontiguousarray(
                tracks[:, i:i + rate].T, "<f4").tobytes())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("file")
    ap.add_argument("-o", "--out", default="laf.wav")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    laf = LafStream(args.file)
    print(f"{args.file}: {laf.quality}, {laf.mode}, "
          f"{len(laf.channels)} channels @ {laf.rate} Hz")

    dev = api.alcLoopbackOpenDeviceSOFT(laf.rate, "stereo", "float32",
                                        device=args.device)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)

    lfe_slot = None
    if any(lfe for _, _, lfe in laf.channels):
        try:
            slot = api.alGenAuxiliaryEffectSlots(1)
            eff = api.alGenEffects(1)
            AL_EFFECT_DEDICATED_LFE = 0x9000   # alext.h
            api.alEffecti(eff, api.AL_EFFECT_TYPE, AL_EFFECT_DEDICATED_LFE)
            api.alAuxiliaryEffectSloti(slot, api.AL_EFFECTSLOT_EFFECT, eff)
            lfe_slot = slot
        except Exception:
            lfe_slot = None

    srcs = []
    for elev_deg, azim_deg, lfe in laf.channels:
        src = api.alGenSources(1)
        api.alSourcef(src, api.AL_ROLLOFF_FACTOR, 0.0)
        api.alSourcei(src, api.AL_SOURCE_RELATIVE, 1)
        # Degrees to radians wrapped to ±pi (allafplay.cpp:749-768).
        azi = ((azim_deg / 180.0 + 1.0) % 2.0 - 1.0) * np.pi
        elev = ((elev_deg / 180.0 + 1.0) % 2.0 - 1.0) * np.pi
        x = np.sin(azi) * np.cos(elev)
        y = np.sin(elev)
        z = -np.cos(azi) * np.cos(elev)
        api.alSource3f(src, api.AL_POSITION, float(x), float(y), float(z))
        if lfe:
            if lfe_slot is not None:
                api.alSource3i(src, api.AL_AUXILIARY_SEND_FILTER,
                               lfe_slot, 0, 0)
            api.alSourcef(src, api.AL_GAIN, 0.0 if lfe_slot is None else 1.0)
        srcs.append(src)

    rendered = []
    while True:
        chans, frames = laf.read_chunk()
        if not frames:
            break
        bufs = []
        for src, seg in zip(srcs, chans):
            buf = api.alGenBuffers(1)
            api.alBufferData(buf, api.AL_FORMAT_MONO_FLOAT32, seg, laf.rate)
            api.alSourceQueueBuffers(src, [buf])
            bufs.append(buf)
        for src in srcs:
            if api.alGetSourcei(src, api.AL_SOURCE_STATE) != api.AL_PLAYING:
                api.alSourcePlay(src)
        # Render this chunk; objects update positions every 48 frames.
        step = FRAMES_PER_POS if laf.n_pos else frames
        off = 0
        while off < frames:
            if laf.n_pos:
                for i in range(len(srcs)):
                    api.alSource3f(srcs[i], api.AL_POSITION,
                                   *laf.object_position(i, off))
            n = min(step, frames - off)
            rendered.append(api.alcRenderSamplesSOFT(dev, n))
            off += n
        for src in srcs:
            done = api.alGetSourcei(src, api.AL_BUFFERS_PROCESSED)
            if done:
                api.alSourceUnqueueBuffers(src, done)

    out = np.concatenate(rendered)
    _write_wav(args.out, out, laf.rate)
    print(f"wrote {args.out} ({laf.done} frames)")


if __name__ == "__main__":
    main()
