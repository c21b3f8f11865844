"""The ring modulator's carrier across a frequency change (ROADMAP C17).

ModulatorState::update rescales the carrier's index to index * range / old
range in integers (the range before the square wave's rounding to even over
the old range after it), so the carrier keeps its phase when the frequency
changes.  Two 1024-sample blocks through the port's engine, at 130 Hz and
then 440 Hz, are held to a float64/integer transcription of that rule: the
index after each block exactly, and each block's output within 1e-5 of the
engine's own highpass and mix applied to the transcribed carrier.  The
modulo rule (the index reduced by the new range) gives another carrier
from the second block on, which the output must not match.  The JAX
package keeps the modulo rule and is not a reference here.  A snapshot
without the engine's ``range`` entry (the JAX package's layout) still
restores and continues.
"""

import numpy as np
import pytest
import torch

from openal_soft_tpu_torch.alc.device import LoopbackDevice
from openal_soft_tpu_torch.effects.base import biquad_fixed, effect_mix
from openal_soft_tpu_torch.effects.modulator import MIX_RAMP

RATE = 48000
T = 1024
FREQS = (130.0, 440.0)
TOL = 1e-5


def reference_carrier(waveform: int, freqs, rescale: bool = True):
    """The carrier of consecutive T-sample blocks, one frequency each
    (modulator.cpp update and Modulate), and the index after each block."""
    index, old = 0, 1
    mods, after = [], []
    for f in freqs:
        rng = int(np.clip(np.float32(RATE) / np.float32(f) + np.float32(0.5),
                          1.0, RATE))
        index = index * rng // old if rescale else index
        if waveform == 2:
            rng = (rng + 1) & ~1
        index %= rng
        old = rng
        i = (index + np.arange(T)) % rng
        if waveform == 0:
            mod = np.sin(i * (2.0 * np.pi / rng))
        elif waveform == 1:
            mod = i * (2.0 / (rng - 1)) - 1.0
        else:
            mod = np.where(i * (1.0 / (rng - 1)) < 0.5, 1.0, -1.0)
        index = (index + T) % rng
        mods.append(mod)
        after.append(index)
    return mods, after


def _expected(wet, z, cur, prm, mod):
    y, z2 = biquad_fixed(wet, z, prm["filter"])
    out, cur2 = effect_mix(y * torch.tensor(mod, dtype=torch.float32),
                           cur, prm["gain_tgt"], T, MIX_RAMP)
    return out, z2, cur2


@pytest.mark.parametrize("waveform", [0, 1, 2], ids=["sin", "saw", "square"])
def test_ring_modulator_rescales_its_index_on_a_new_range(waveform):
    dev = LoopbackDevice(frequency=RATE, channels="stereo", capacity=4,
                         device="cpu")
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    eff = ctx.create_effect("ring_modulator")
    eff.set("frequency", FREQS[0])
    eff.set("waveform", waveform)
    slot.set_effect(eff)
    st = dev._state["slot0"]
    mods, after = reference_carrier(waveform, FREQS)
    modulo, _ = reference_carrier(waveform, FREQS, rescale=False)
    assert not np.allclose(mods[1], modulo[1])   # the rules part here
    z = st["z"].clone()
    cur = st["gain_cur"].clone()
    rng = np.random.default_rng(waveform)
    for b, f in enumerate(FREQS):
        slot.set_props(frequency=f)
        prm = {k: torch.tensor(np.asarray(v))
               for k, v in slot.compute_update().items()}
        wet = torch.tensor((0.3 * rng.standard_normal((dev.wet_channels, T))
                            ).astype(np.float32))
        out, _, _ = slot.state.process(st, prm, wet, T)
        if b:
            other, _, _ = _expected(wet, z, cur, prm, modulo[b])
            assert np.abs(out.numpy() - other.numpy()).max() > 100 * TOL
        want, z, cur = _expected(wet, z, cur, prm, mods[b])
        assert int(st["index"]) == after[b]
        assert np.abs(out.numpy() - want.numpy()).max() <= TOL


def test_ring_modulator_snapshot_without_range_restores():
    """The JAX package's modulator state has no ``range``: restored into
    the port it continues as the port's own snapshot does."""
    def scene():
        dev = LoopbackDevice(frequency=RATE, channels="stereo", capacity=4,
                             device="cpu")
        ctx = dev.create_context()
        slot = ctx.create_aux_slot()
        eff = ctx.create_effect("ring_modulator")
        eff.set("frequency", FREQS[0])
        slot.set_effect(eff)
        buf = ctx.create_buffer()
        buf.set_data((0.3 * np.sin(np.arange(4800) * 0.05)
                      ).astype(np.float32), "mono", "float32", RATE)
        src = ctx.create_source()
        src.buffer(buf)
        src.looping = True
        src.send(slot, 0)
        src.play()
        return dev

    dev = scene()
    dev.render_samples(2048)
    snap = dev.snapshot()
    assert "range" in snap["state"]["slot0"]
    outs = []
    for drop in (False, True):
        other = scene()
        if drop:
            del snap["state"]["slot0"]["range"]
        other.restore(snap)
        outs.append(other.render_samples(2048))
    assert np.array_equal(outs[0], outs[1]) and np.abs(outs[0]).max() > 0
