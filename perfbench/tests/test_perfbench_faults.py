"""The comparison fails a run whose timed path is broken underneath: the
harness's look for a card skipped, the rest of a run driven at a tiny size
on the CPU, one fault planted in the program each time.  (A cell on one
card has no exchange between cards to leave out.)"""

import pytest
import torch

from harness import registry, runner
from tiny import tiny_cell
from openal_soft_tpu_torch.core import device as port_device

RenderDevice = port_device.RenderDevice


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def state_unchanged(monkeypatch):
    """Each render returns its output but leaves the carried state as it
    found it."""
    orig = RenderDevice._render_dispatch

    def render(self, out, done, remaining):
        kept = clone_tree(self._state)
        served = orig(self, out, done, remaining)
        self._state = kept
        return served

    monkeypatch.setattr(RenderDevice, "_render_dispatch", render)


def half_the_voices(monkeypatch):
    """The resampler's output for the upper half of the voice rows is
    dropped, and the rest counts double: the level of the whole, from half
    of the voices."""
    orig = RenderDevice._resample

    def resample(self, *args, **kw):
        x = orig(self, *args, **kw).clone()
        x[x.shape[0] // 2:] = 0.0
        x[:x.shape[0] // 2] *= 2.0
        return x

    monkeypatch.setattr(RenderDevice, "_resample", resample)


def answer_altered(monkeypatch):
    """One sample of each call's output is off where the entry returns it."""
    orig = RenderDevice.render_samples

    def render_samples(self, n):
        out = orig(self, n)
        out[n // 2, 0] += 1e-3
        return out

    monkeypatch.setattr(RenderDevice, "render_samples", render_samples)


FAULTS = {"state_unchanged": state_unchanged,
          "half_the_voices": half_the_voices,
          "answer_altered": answer_altered}
CELLS = [w["name"] for w in registry.load_bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = runner.run_cell(tiny_cell(cell), 2**31 + 77, 0.2, False,
                          device="cpu")
    assert not res["correct"], res["checks"]


def test_sound_run_is_correct():
    torch.manual_seed(0)
    res = runner.run_cell(tiny_cell("hrtf4096.best_case"), 2**31 + 77, 0.2,
                          False, device="cpu")
    assert res["correct"], res["checks"]
