"""IMA4 and MSADPCM block decoding (core/voice.cpp:186-474).

The reference decodes ADPCM lazily inside the mixer hot loop; here buffers
are decoded once at upload time to f32 planar (SURVEY.md §2.1 "Storage
formats": host decode to f32 planar on upload), which is bit-identical and
removes data-dependent control flow from the device path.
"""

from __future__ import annotations

import numpy as np

IMA_STEP_SIZE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19,
    21, 23, 25, 28, 31, 34, 37, 41, 45, 50, 55,
    60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157,
    173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449,
    494, 544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282,
    1411, 1552, 1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660,
    4026, 4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442,
    11487, 12635, 13899, 15289, 16818, 18500, 20350, 22358, 24633, 27086, 29794,
    32767], np.int32)

IMA4_CODEWORD = np.array([1, 3, 5, 7, 9, 11, 13, 15,
                          -1, -3, -5, -7, -9, -11, -13, -15], np.int32)
IMA4_INDEX_ADJUST = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                              -1, -1, -1, -1, 2, 4, 6, 8], np.int32)

MSADPCM_ADAPTION = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                             768, 614, 512, 409, 307, 230, 230, 230], np.int32)
MSADPCM_COEFFS = np.array([[256, 0], [512, -256], [0, 0], [192, 64],
                           [240, 0], [460, -208], [392, -232]], np.int32)


def _trunc_div(a: int, b: int) -> int:
    """C-style integer division (truncates toward zero, unlike Python //)."""
    q = abs(a) // b
    return -q if a < 0 else q


def decode_ima4(data: np.ndarray, channels: int, samples_per_block: int) -> np.ndarray:
    """Decode IMA4 blocks → [channels, frames] f32."""
    block_bytes = ((samples_per_block - 1) // 2 + 4) * channels
    nblocks = data.size // block_bytes
    out = np.zeros((channels, nblocks * samples_per_block), np.float32)
    for b in range(nblocks):
        blk = data[b * block_bytes:(b + 1) * block_bytes]
        for ch in range(channels):
            sample = int(np.int16(blk[ch * 4] | (int(blk[ch * 4 + 1]) << 8)))
            idx = int(np.int16(blk[ch * 4 + 2] | (int(blk[ch * 4 + 3]) << 8)))
            idx = min(max(idx, 0), len(IMA_STEP_SIZE) - 1)
            base = b * samples_per_block
            out[ch, base] = sample / 32768.0
            nibble_data = blk[channels * 4:]
            for i in range(samples_per_block - 1):
                byte_shift = (i & 1) * 4
                word_off = (i >> 1) & ~3
                byte_off = word_off * channels + ch * 4 + ((i >> 1) & 3)
                nib = (int(nibble_data[byte_off]) >> byte_shift) & 0xF
                sample += _trunc_div(int(IMA4_CODEWORD[nib]) * int(IMA_STEP_SIZE[idx]), 8)
                sample = min(max(sample, -32768), 32767)
                idx = min(max(idx + int(IMA4_INDEX_ADJUST[nib]), 0),
                          len(IMA_STEP_SIZE) - 1)
                out[ch, base + 1 + i] = sample / 32768.0
    return out


def decode_msadpcm(data: np.ndarray, channels: int, samples_per_block: int) -> np.ndarray:
    """Decode MSADPCM blocks → [channels, frames] f32."""
    block_bytes = ((samples_per_block - 2) // 2 + 7) * channels
    nblocks = data.size // block_bytes
    out = np.zeros((channels, nblocks * samples_per_block), np.float32)
    for b in range(nblocks):
        blk = data[b * block_bytes:(b + 1) * block_bytes]
        for ch in range(channels):
            pred = min(int(blk[ch]), len(MSADPCM_COEFFS) - 1)
            scale = int(np.int16(blk[channels + 2 * ch]
                                 | (int(blk[channels + 2 * ch + 1]) << 8)))
            h0 = int(np.int16(blk[3 * channels + 2 * ch]
                              | (int(blk[3 * channels + 2 * ch + 1]) << 8)))
            h1 = int(np.int16(blk[5 * channels + 2 * ch]
                              | (int(blk[5 * channels + 2 * ch + 1]) << 8)))
            c0, c1 = int(MSADPCM_COEFFS[pred][0]), int(MSADPCM_COEFFS[pred][1])
            base = b * samples_per_block
            out[ch, base] = h1 / 32768.0        # older history first
            out[ch, base + 1] = h0 / 32768.0
            nibble_data = blk[7 * channels:]
            nibble_off = ch
            for i in range(samples_per_block - 2):
                byte_off = nibble_off >> 1
                byte_shift = ((nibble_off & 1) ^ 1) * 4
                nval = (int(nibble_data[byte_off]) >> byte_shift) & 0xF
                pred_s = ((nval ^ 0x8) - 0x8) * scale
                diff = _trunc_div(h0 * c0 + h1 * c1, 256)
                sample = min(max(pred_s + diff, -32768), 32767)
                h1, h0 = h0, sample
                scale = max(_trunc_div(int(MSADPCM_ADAPTION[nval]) * scale, 256), 16)
                out[ch, base + 2 + i] = sample / 32768.0
                nibble_off += channels
    return out
