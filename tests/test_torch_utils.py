"""The port's offline tools against the JAX package's, on the CPU.

- UHJ: the FIR encoder and decoder tools at BLOCK = 256 (set on both
  packages' modules for the test, so XLA:CPU compiles small graphs) on
  seeded 2-, 3- and 4-channel input, within 2e-6 (the FIR codecs' bound
  of test_torch_uhj.py).  The iir tier is never run through the JAX
  package on XLA:CPU (its all-pass cascade exhausts XLA's code memory);
  the port's tool is held bit-equal to the port's ops.uhj.uhj_encode_iir
  called block by block instead.
- makemhr: every stage and the written .mhr byte-equal to the JAX module
  on test_makemhr.py's grid, and through a definition file with one
  synthesized elevation.  On a set whose first measured ring is 5
  (repaired fault C2), the rows outside the blended part of the gap equal
  JAX's; the blended rows equal a float64 transcription of
  makemhr.cpp:672-706 written here, and differ from JAX's.
- sofa_info / load_sofa against the JAX tool on a file written with h5py.
- openal_info and the tools' default device (the card) on this machine.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openal_soft_tpu.utils import makemhr as jmhr
from openal_soft_tpu.utils import sofa_info as jsofa
from openal_soft_tpu.utils import uhjdecoder as jdec
from openal_soft_tpu.utils import uhjencoder as jenc
from openal_soft_tpu_torch.ops import uhj as uhj_ops
from openal_soft_tpu_torch.utils import makemhr as pmhr
from openal_soft_tpu_torch.utils import openal_info
from openal_soft_tpu_torch.utils import sofa_info as psofa
from openal_soft_tpu_torch.utils import uhjdecoder as pdec
from openal_soft_tpu_torch.utils import uhjencoder as penc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIR_TOL = 2e-6
RATE = 44100


@pytest.fixture
def small_blocks(monkeypatch):
    for mod in (jenc, jdec, penc, pdec):
        monkeypatch.setattr(mod, "BLOCK", 256)


def _signal(channels: int, frames: int = 700, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + channels)
    return (0.3 * rng.standard_normal((frames, channels))).astype(np.float32)


# --- UHJ ---------------------------------------------------------------------

@pytest.mark.parametrize("tool", ["encode", "decode"])
@pytest.mark.parametrize("tier", ["fir256", "fir512"])
@pytest.mark.parametrize("channels", [2, 3, 4])
def test_uhj_fir_tools_match_jax(small_blocks, tool, tier, channels):
    data = _signal(channels)
    if tool == "encode":
        want, got = jenc.encode(data, tier), penc.encode(data, tier, "cpu")
    else:
        want, got = jdec.decode(data, tier), pdec.decode(data, tier, "cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got).max() > 0.01
    assert np.abs(got - want).max() <= FIR_TOL


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_uhj_iir_tool_is_the_block_codec(small_blocks, channels):
    """The iir tier: the tool equals ops.uhj.uhj_encode_iir over the same
    256-sample blocks, bit for bit."""
    data = _signal(channels, frames=600)
    got = penc.encode(data, "iir", "cpu")
    foa = penc._to_foa(data)
    foa = np.pad(foa, ((0, 0), (0, (-foa.shape[1]) % 256)))
    st = uhj_ops.uhj_encoder_iir_state(torch.device("cpu"))
    outs = []
    for i in range(0, foa.shape[1], 256):
        w, x, y = (torch.from_numpy(np.ascontiguousarray(foa[c, i:i + 256]))
                   for c in range(3))
        left, right, st = uhj_ops.uhj_encode_iir(w, x, y, st, 256)
        outs.append(torch.stack([left, right], 1).numpy())
    want = np.concatenate(outs)[:data.shape[0]]
    assert got.shape == (data.shape[0], 2) and np.abs(got).max() > 0.01
    np.testing.assert_array_equal(got, want)


def test_uhj_command_lines_round_trip(tmp_path):
    """Both tools' command lines on the CPU: a B-Format WAV to UHJ and
    back, each output the tool's function on the file's samples."""
    src, uhj, bf = (str(tmp_path / n) for n in ("in.wav", "u.wav", "b.wav"))
    penc._write_wav(src, _signal(4, 3000), 48000)
    penc.main([src, uhj, "--tier", "fir256", "--device", "cpu"])
    pdec.main([uhj, bf, "--tier", "fir512", "--device", "cpu"])
    data, rate = penc._read_wav(src)
    enc, _ = penc._read_wav(uhj)
    dec, _ = pdec._read_wav(bf)
    assert rate == 48000 and enc.shape == (3000, 2) and dec.shape == (3000, 3)
    assert np.abs(enc - penc.encode(data, "fir256", "cpu")).max() <= 2 ** -15
    assert np.abs(dec - pdec.decode(enc, "fir512", "cpu")).max() <= 2 ** -15


# --- makemhr -----------------------------------------------------------------

def _grid_set(mod, rng, az_counts=(1, 8, 12, 8, 1), ir_size=64, channels=2,
              ev_start=0):
    """test_makemhr.py's synthetic grid (onset + decaying noise per IR),
    optionally with the rings below ``ev_start`` left unmeasured."""
    n = sum(az_counts)
    irs = np.zeros((n, channels, ir_size))
    t = np.arange(ir_size)
    first = sum(az_counts[:ev_start])
    for i in range(first, n):
        for ch in range(channels):
            onset = 3 + (i + ch) % 9
            env = np.exp(-np.maximum(t - onset, 0) / 6.0) * (t >= onset)
            irs[i, ch] = env * rng.standard_normal(ir_size) * 0.5
            irs[i, ch, onset] = 1.0
    return mod.HrirSet(RATE, [(1.2, list(az_counts))], irs,
                       ev_starts=[ev_start] if ev_start else None)


def _stages(mod, hset, fft):
    onsets = mod.calc_onsets(hset)
    mags = mod.calc_magnitudes(hset.irs, fft)
    dfa = mod.diffuse_field_average(hset, mags, fft)
    irs = mod.normalize_hrirs(mod.minimum_phase(mags / dfa[None], fft, 32))
    return {"onsets": onsets, "mags": mags, "dfa": dfa, "irs": irs,
            "hrtds": mod.calc_hrtds(hset, onsets),
            "sphere": mod.calc_hrtds(hset, onsets, model="sphere")}


@pytest.mark.parametrize("channels", [1, 2])
def test_makemhr_stages_and_file_match_jax(tmp_path, channels):
    j = _grid_set(jmhr, np.random.default_rng(9), channels=channels)
    p = _grid_set(pmhr, np.random.default_rng(9), channels=channels)
    sj, sp = _stages(jmhr, j, 1024), _stages(pmhr, p, 1024)
    for name in sj:
        np.testing.assert_allclose(sp[name], sj[name], rtol=0, atol=1e-12,
                                   err_msg=name)
    jmhr.process_hrir_set(j, str(tmp_path / "j.mhr"), fft_size=1024,
                          trunc_size=32)
    pmhr.process_hrir_set(p, str(tmp_path / "p.mhr"), fft_size=1024,
                          trunc_size=32)
    assert (tmp_path / "p.mhr").read_bytes() == (tmp_path / "j.mhr"
                                                 ).read_bytes()


def test_makemhr_definition_file_matches_jax(tmp_path):
    """A .def set with its bottom elevation missing (ev_start 1: the pole
    mirrored, no blended ring) compiles to the JAX module's bytes."""
    import struct

    rng = np.random.default_rng(12)
    az_counts, ir_size = [1, 4, 6, 4, 1], 64
    lines = ["rate = 44100", "type = mono", f"points = {ir_size}",
             "radius = 0.09", "distance = 1.0",
             "azimuths = " + ", ".join(map(str, az_counts))]
    t = np.arange(ir_size)
    for ei in range(1, len(az_counts)):
        for ai in range(az_counts[ei]):
            onset = 3 + (ei * 3 + ai) % 9
            ir = np.exp(-np.maximum(t - onset, 0) / 6.0) * (t >= onset)
            ir = ir * (0.4 + 0.1 * rng.standard_normal(ir_size))
            ir[onset] = 0.9
            pcm = np.clip(ir * 32767.0, -32768, 32767).astype("<i2")
            with open(tmp_path / f"e{ei}a{ai}.wav", "wb") as f:
                f.write(b"RIFF" + struct.pack("<I", 36 + pcm.nbytes)
                        + b"WAVE" + b"fmt " + struct.pack(
                            "<IHHIIHH", 16, 1, 1, RATE, RATE * 2, 2, 16)
                        + b"data" + struct.pack("<I", pcm.nbytes)
                        + pcm.tobytes())
            lines.append(f'[ {ei}, {ai} ] = wave (0) : "./e{ei}a{ai}.wav"')
    (tmp_path / "set.def").write_text("\n".join(lines) + "\n")
    j, p = (m.load_def(str(tmp_path / "set.def")) for m in (jmhr, pmhr))
    assert p.ev_starts == j.ev_starts == [1]
    np.testing.assert_array_equal(p.irs, j.irs)
    jmhr.process_hrir_set(j, str(tmp_path / "j.mhr"), fft_size=512,
                          trunc_size=32)
    pmhr.process_hrir_set(p, str(tmp_path / "p.mhr"), fft_size=512,
                          trunc_size=32)
    assert (tmp_path / "p.mhr").read_bytes() == (tmp_path / "j.mhr"
                                                 ).read_bytes()


# A grid whose first measured ring is 5 of 12: rings 1-2 are mirrored from
# the top, ring 3-4 blended (lowerElevFake = 2), ring 0 the pole.
GAP_AZ = (1, 6, 8, 10, 12, 12, 12, 12, 10, 8, 6, 1)
GAP_START = 5


def _reference_blend(onsets: np.ndarray, az_counts, ev_start: int
                     ) -> dict:
    """makemhr.cpp:672-706 in float64: the rings between the lowest
    mirrored ring (lowerElevFake) and the first measured one, each the
    bilinear blend of those two rings by elevation angle and by each ring's
    own azimuth indices (CalcAzIndices, makemhr.cpp:566-579)."""
    nev = len(az_counts)
    offs = np.concatenate([[0], np.cumsum(az_counts)])
    elev = [-np.pi / 2 + np.pi * e / (nev - 1) for e in range(nev)]
    ei = max((ev_start + 1) // 2, 1)
    lower = ei - 1

    def indices(ring, az):
        n = az_counts[ring]
        f = (2.0 * np.pi + az) * n / (2.0 * np.pi)
        i = int(f) % n
        return i, (i + 1) % n, f - np.floor(f)

    want = {}
    for ring in range(ei, ev_start):
        ef = ((elev[ev_start] - elev[ring])
              / (elev[ev_start] - elev[lower]))
        for ai in range(az_counts[ring]):
            az = 2.0 * np.pi * ai / az_counts[ring]
            a0, a1, af0 = indices(ev_start, az)
            a2, a3, af1 = indices(lower, az)
            up = onsets[offs[ev_start] + np.array([a0, a1])]
            lo = onsets[offs[lower] + np.array([a2, a3])]
            want[offs[ring] + ai] = ((1 - ef) * (1 - af0) * up[0]
                                     + (1 - ef) * af0 * up[1]
                                     + ef * (1 - af1) * lo[0]
                                     + ef * af1 * lo[1])
    return want


@pytest.mark.parametrize("channels", [1, 2])
def test_makemhr_onset_gap_follows_the_reference(channels):
    """C2: the JAX module blends the gap from the bottom pole by ei /
    ev_start; the port blends it as makemhr.cpp does."""
    j = _grid_set(jmhr, np.random.default_rng(5), GAP_AZ, channels=channels,
                  ev_start=GAP_START)
    p = _grid_set(pmhr, np.random.default_rng(5), GAP_AZ, channels=channels,
                  ev_start=GAP_START)
    onsets = jmhr.calc_onsets(j)
    np.testing.assert_array_equal(pmhr.calc_onsets(p), onsets)
    want_j = jmhr.synthesize_onsets(j, onsets)
    got = pmhr.synthesize_onsets(p, onsets)
    blend = _reference_blend(got, GAP_AZ, GAP_START)
    rows = sorted(blend)
    assert rows == list(range(sum(GAP_AZ[:3]), sum(GAP_AZ[:5])))
    other = np.setdiff1d(np.arange(got.shape[0]), rows)
    np.testing.assert_array_equal(got[other], want_j[other])
    np.testing.assert_allclose(got[rows], np.array([blend[r] for r in rows]),
                               rtol=0, atol=1e-12)
    # Onsets are in seconds: the two rules part by more than a sample.
    assert np.abs(got[rows] - want_j[rows]).max() > 1.0 / RATE


def test_makemhr_gap_set_compiles(tmp_path):
    """The same gap set through the whole pipeline: a loadable file whose
    HRIRs equal the JAX module's (only the onsets are repaired)."""
    from openal_soft_tpu_torch.core import hrtf

    j = _grid_set(jmhr, np.random.default_rng(6), GAP_AZ, ev_start=GAP_START)
    p = _grid_set(pmhr, np.random.default_rng(6), GAP_AZ, ev_start=GAP_START)
    jmhr.process_hrir_set(j, str(tmp_path / "j.mhr"), fft_size=512,
                          trunc_size=32)
    pmhr.process_hrir_set(p, str(tmp_path / "p.mhr"), fft_size=512,
                          trunc_size=32)
    sj = hrtf.load_mhr(str(tmp_path / "j.mhr"))
    sp = hrtf.load_mhr(str(tmp_path / "p.mhr"))
    np.testing.assert_array_equal(sp.coeffs, sj.coeffs)
    assert list(sp.elev_az_counts) == list(GAP_AZ)
    assert (sp.delays != sj.delays).any()


# --- SOFA --------------------------------------------------------------------

def test_sofa_info_matches_jax(tmp_path, capsys, monkeypatch):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(12)
    pos = [(az, el, 1.5) for el in (-30.0, 0.0, 30.0)
           for az in (0.0, 90.0, 180.0, 270.0)]
    path = str(tmp_path / "tiny.sofa")
    with h5py.File(path, "w") as f:
        f.attrs["Conventions"] = "SOFA"
        f.attrs["DatabaseName"] = b"seeded"
        f.create_dataset("Data.IR", data=rng.standard_normal(
            (len(pos), 2, 48)) * 0.3)
        f.create_dataset("Data.SamplingRate", data=np.array([RATE], float))
        f.create_dataset("Data.Delay", data=np.zeros((1, 2)))
        f.create_dataset("SourcePosition", data=np.array(pos, float))
        f.create_dataset("EmitterPosition", data=np.zeros((1, 3)))
    j, p = jmhr.load_sofa(path), pmhr.load_sofa(path)
    assert p.fields == j.fields == [(1.5, [4, 4, 4])]
    np.testing.assert_array_equal(p.irs, j.irs)
    monkeypatch.setattr(sys, "argv", ["sofa_info", path])
    jsofa.main()
    want = capsys.readouterr().out
    psofa.main([path])
    got = capsys.readouterr().out
    assert got == want and "Compatible Layout (12 of 12" in got


# --- openal_info and the default device --------------------------------------

def test_openal_info_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "openal_soft_tpu_torch.utils.openal_info",
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert any(ln.startswith("effects (17): ") for ln in lines)
    assert any(ln.startswith("reverb presets (113): ") for ln in lines)
    assert "device: cpu" in res.stdout and "1982 HRIRs" in res.stdout


@pytest.mark.parametrize("entry", ["uhjencoder", "uhjdecoder",
                                   "openal_info"])
def test_tools_default_to_the_card(entry):
    """Without --device the tools ask for the card, and raise without one
    (resolve_device) instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device opens")
    data = _signal(2, 300)
    run = {"uhjencoder": lambda: penc.encode(data, "fir256"),
           "uhjdecoder": lambda: pdec.decode(data, "fir256"),
           "openal_info": lambda: openal_info.main([])}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        run()
