"""The reference on its own: its reader of the HRTF data set, its HRIR
selection, and its render against an output of OpenAL Soft itself (the C
library, rendered once into ``reference/witness/``)."""

import numpy as np
import pytest

from harness import runner
from reference import binaural, mhr

RATE = 48000
WITNESS = runner.registry.BENCH_DIR / "reference" / "witness"


@pytest.fixture(scope="module")
def hset():
    return mhr.load(runner.HRTF_PATH)


def _tone(n, freq, gain=0.4):
    t = np.arange(n) / RATE
    return (gain * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def test_data_set_layout(hset):
    assert hset.rate == RATE and hset.ir_size == 64
    assert list(hset.field_ev_count) == [13]
    assert hset.az_count[0] == hset.az_count[-1] == 1
    assert len(hset.coeffs) == int(hset.az_count.sum())
    assert not hset.coeffs[:, hset.ir_size:].any()
    # A left-only set: the right ear of azimuth j is the left of n - j.
    o, n = hset.ir_offset[6], hset.az_count[6]
    assert np.array_equal(hset.coeffs[o + 10, :, 1],
                          hset.coeffs[o + n - 10, :, 0])
    assert hset.delays[o + 10, 1] == hset.delays[o + n - 10, 0]


def test_openal_soft_output(hset):
    """One voice at (1, 0.3, -2) looping a 440 Hz tone, 4096 frames, as
    OpenAL Soft's own library rendered it (headphones, its default HRTF)."""
    want = np.load(WITNESS / "hrtf_single.npz")["out"]
    ref = binaural.Binaural(hset, [_tone(24000, 440.0)], [0],
                            np.array([[1.0, 0.3, -2.0]]), RATE)
    got = ref.render(0, 4096)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_calls_split_anywhere(hset):
    rng = np.random.default_rng(3)
    tones = [_tone(1000 + 37 * i, 200.0 * (i + 1), 0.1) for i in range(3)]
    pos = rng.standard_normal((7, 3)) * 3.0
    ref = binaural.Binaural(hset, tones, np.arange(7) % 3, pos, RATE,
                            block=700)
    whole = ref.render(0, 3000)
    parts = np.concatenate([ref.render(0, 1234), ref.render(1234, 1766)])
    assert np.abs(whole - parts).max() <= 1e-7 * np.abs(whole).max()


def test_gain_and_direction(hset):
    pos = np.array([[0.0, 0.0, -0.5], [0.0, 0.0, -4.0], [3.0, 0.0, 0.0],
                    [0.0, 5.0, 0.0]])
    ev, az, dist = binaural.direction(pos)
    assert np.allclose(binaural.distance_gain(dist), [1.0, 0.25, 1 / 3, 0.2])
    assert np.allclose(az[:3], [0.0, 0.0, np.pi / 2], atol=1e-6)
    assert np.allclose(ev, [0.0, 0.0, 0.0, np.pi / 2], atol=1e-6)
    coeffs, delays = binaural.select_hrirs(hset, ev, az)
    # Straight ahead the two ears hear the same; to the right, the left
    # ear hears later.
    assert np.array_equal(coeffs[0, :, 0], coeffs[0, :, 1])
    assert delays[2, 0] > delays[2, 1]
    with pytest.raises(ValueError):
        binaural.direction(np.zeros((1, 3)))


def test_a_tie_takes_the_delay_that_fits(hset):
    """A voice-ear whose delay round-off can move: the output of the other
    rounding is recognised as the reference's, a third one is not."""
    pos = np.array([[0.05528697744011879, 4.211470127105713,
                     -1.0213160514831543]])          # near the pole
    ref = binaural.Binaural(hset, [_tone(4800, 300.0)], [0], pos, RATE)
    assert len(ref.ties) == 1
    v, ear, others = ref.ties[0]
    d = others[0]
    moved = ref.render(0, 2048).astype(np.float64)
    moved[:, ear] += ref._moved(v, ear, d, 0, 2048)
    got = ref.render_compared([(0, 2048, moved)])[0]
    assert np.abs(got - moved).max() <= 1e-7 * np.abs(moved).max()
    shifted = ref.render(0, 2048).astype(np.float64)
    shifted[:, ear] += ref._moved(v, ear, d + 2 * (d - ref.delays[v, ear]),
                                  0, 2048)
    got = ref.render_compared([(0, 2048, shifted)])[0]
    assert np.abs(got - shifted).max() > 1e-3 * np.abs(shifted).max()
