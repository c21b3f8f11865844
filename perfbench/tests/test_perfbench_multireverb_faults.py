"""Faults the ``surround51.multireverb`` cell's comparison must catch, at
a tiny size on the CPU, one planted in the program each time: one sample
of the output altered, one zone's decay time off by 1 %, the decode
taken single-band (the high band's matrix over the whole bus), and the
zones' upmix given the 3D HF scales on the 2D bus."""

import pytest

from harness import runner
from tiny import tiny_cell
from openal_soft_tpu_torch.core import ambidefs
from openal_soft_tpu_torch.core import device as port_device
from openal_soft_tpu_torch.core import effectslot
from openal_soft_tpu_torch.effects import reverb

CELL = "surround51.multireverb"
RenderDevice = port_device.RenderDevice


def sample_altered(monkeypatch):
    """One sample of each call's output is off by 1e-4 (0.03 % of the
    output's peak)."""
    orig = RenderDevice.render_samples

    def render_samples(self, n):
        out = orig(self, n)
        out[n // 2, 4] += 1e-4
        return out

    monkeypatch.setattr(RenderDevice, "render_samples", render_samples)


def decay_off(monkeypatch):
    """The second zone (Bathroom, 1.49 s) decays over 1.5049 s."""
    orig = effectslot.EffectSlot.set_effect

    def set_effect(self, effect):
        orig(self, effect)
        if self.index == 1:
            self.set_props(decay_time=self.effect_props["decay_time"] * 1.01)

    monkeypatch.setattr(effectslot.EffectSlot, "set_effect", set_effect)


def single_band(monkeypatch):
    """The decode drops its low band: dec_hf over the whole dry bus."""
    orig = RenderDevice.__init__

    def init(self, *args, **kw):
        orig(self, *args, **kw)
        self._dec_lf = None

    monkeypatch.setattr(RenderDevice, "__init__", init)


def upmix_3d(monkeypatch):
    """The reverbs' first-order output takes the 3D HF order scales (W's
    high band 4 / 2.981 = 1.342) where 5.1's 2D bus wants the 2D ones
    (2.236 / 1.826 = 1.225)."""
    orig = ambidefs.hf_order_scales

    def hf_order_scales(src, dev, horizontal_only):
        return orig(src, dev, False)

    monkeypatch.setattr(reverb.ambidefs, "hf_order_scales", hf_order_scales)


FAULTS = {"sample_altered": sample_altered, "decay_off": decay_off,
          "single_band": single_band, "upmix_3d": upmix_3d}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = runner.run_cell(tiny_cell(CELL), 2**31 + 77, 0.2, False,
                          device="cpu")
    assert not res["correct"], res["checks"]
