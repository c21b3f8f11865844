"""The 5.1 deployment with two EAX reverb zones (the benchmark's
``surround51.multireverb`` cell) at a size the CPU holds: 16 pitched,
filtered voices sent to both zones, built through the port's al.api by the
cell's own scene recipe, against the benchmark's float64 speaker reference
(``perfbench/reference/speakers.py``); the reference's warm-up truncation;
and the ranges and counters the block path keeps for the cell's per-layer
metrics."""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from harness import registry, runner  # noqa: E402

from openal_soft_tpu_torch.al import api as al  # noqa: E402
from openal_soft_tpu_torch.alc import config  # noqa: E402
from openal_soft_tpu_torch.core import device as port_device  # noqa: E402

CELL = "surround51.multireverb"
VOICES = 16
BLOCKS = 4
FRAMES = BLOCKS * 1024
# The program renders in float32; its reverbs' feedback and chunked
# shelves carry the most round-off: 0.42e-6 to 0.75e-6 of the output's peak
# at this size against the float64 reference, on four seeds.  A zone's
# decay 1 % off reads 1.3e-3, one sample off by 1e-4 reads 4e-4 (perfbench/
# tests/test_perfbench_multireverb_faults.py).
TOL = 1e-5


def small_cell():
    cell = registry.cell(registry.load_bench(), CELL)
    cell.config["device"]["capacity"] = VOICES
    cell.traffic["scene_params"]["voices"] = VOICES
    return cell


@contextlib.contextmanager
def scene_built(cell, seed, device="cpu"):
    """The cell's scene through al.api on ``device``, under its
    alsoft.conf."""
    scene = runner.scene_inputs(cell, seed)
    try:
        with runner.alsoft_conf(cell):
            config.load_config(reload=True)
            built = runner.scene_module(cell).build(al, cell.config, scene,
                                                    device)
            yield scene, built["dev"]
    finally:
        al.alcMakeContextCurrent(None)
        config.load_config(reload=True)


def reference(cell, scene, **kw):
    ref = runner.scene_module(cell).reference(cell.config, scene, None,
                                              "cpu", torch.float64)
    for k, v in kw.items():
        setattr(ref, k, v)
    return ref


def gap(prog, ref) -> float:
    return float(np.abs(prog.astype(np.float64) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("seed", [2**31 + 17, 3000000001])
def test_port_matches_the_reference(seed):
    """Four calls of four blocks from the first frame: the send filters'
    start-up interpolation, the zones' first-chunk crossfades and output
    ramps, then steady state."""
    cell = small_cell()
    with scene_built(cell, seed) as (scene, dev):
        outs = [al.alcRenderSamplesSOFT(dev, FRAMES).copy()
                for _ in range(4)]
    ref = reference(cell, scene)
    for k, out in enumerate(outs):
        assert out.shape == (FRAMES, 6)
        assert not out[:, 3].any()                  # nothing on the LFE
        assert gap(out, ref.render(k * FRAMES, FRAMES)) < TOL, k


def test_a_voice_rebased_onto_its_loop_start_reads_the_loop_end():
    """A looping voice at pitch 0.5 over a 2048-frame tone lands exactly on
    frame 0 after every fourth 1024-frame block; the spline's first tap
    then reads the frame before it, the tone's last (silence only before
    the voice's first frame)."""
    cell = small_cell()
    cell.config["device"]["capacity"] = 1
    cell.traffic["scene_params"]["voices"] = 1
    scene = runner.scene_inputs(cell, 2**31 + 3)
    n = 2048
    scene["tones"] = [(0.3 * np.sin(2 * np.pi * 5.5 * np.arange(n) / n + 1.0)
                       ).astype(np.float32)]
    scene["voice_tone"] = np.zeros(1, np.int64)
    scene["pitch"] = np.array([0.5])
    scene["positions"] = np.array([[0.5, 0.0, -1.5]])
    try:
        with runner.alsoft_conf(cell):
            config.load_config(reload=True)
            dev = runner.scene_module(cell).build(al, cell.config, scene,
                                                  "cpu")["dev"]
            outs = [al.alcRenderSamplesSOFT(dev, 1024).copy()
                    for _ in range(9)]
    finally:
        al.alcMakeContextCurrent(None)
        config.load_config(reload=True)
    ref = reference(cell, scene)
    for k, out in enumerate(outs):
        assert gap(out, ref.render(k * 1024, 1024)) < TOL, k


def test_range_from_zero_state_equals_the_full_replay():
    """The reference renders a range [a, a + n) from zero state at a - W:
    past W frames the zones' reverbs, the filters and the splitters have
    forgotten their input, so the range equals the render that replays the
    scene from the first frame, to 1e-12 of its peak."""
    cell = small_cell()
    scene = runner.scene_inputs(cell, 2**31 + 29)
    cut = reference(cell, scene)
    a = cut.warmup + 3 * FRAMES + 123
    full = reference(cell, scene, warmup=a)
    x, y = cut.render(a, FRAMES), full.render(a, FRAMES)
    assert np.abs(y).max() > 0.01
    assert np.abs(x.astype(np.float64) - y).max() <= 1e-12 * np.abs(y).max()


SPANS = ("alsoft.filters", "alsoft.wet_buses", "alsoft.slots",
         "alsoft.slot.eaxreverb", "alsoft.decode")


def test_ranges_open_in_a_profile_and_counters_count():
    cell = small_cell()
    seed = 2**31 + 41
    with scene_built(cell, seed) as (_, dev):
        plain = [al.alcRenderSamplesSOFT(dev, FRAMES).copy()
                 for _ in range(3)]
    assert isinstance(port_device._span("alsoft.x"),
                      contextlib.nullcontext)
    with scene_built(cell, seed) as (_, dev):
        outs = [al.alcRenderSamplesSOFT(dev, FRAMES).copy()
                for _ in range(2)]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            outs.append(al.alcRenderSamplesSOFT(dev, FRAMES).copy())
        counts = (dict(dev.slot_blocks), dev.filter_rows,
                  dev.decode_blocks_dual)
    names = {e.name for e in prof.events()}
    assert set(SPANS) <= names
    # The ranges change nothing the program computes.
    for a, b in zip(plain, outs):
        assert np.array_equal(a, b)
    blocks = 3 * BLOCKS
    # Two slots a block; the direct path and two sends a voice a block.
    assert counts == ({"eaxreverb": 2 * blocks}, 3 * VOICES * blocks, blocks)


@pytest.mark.cuda
def test_speaker_path_runs_five_band_splits_a_block_on_the_card():
    """On the card each block runs the band-split kernel five times: each
    zone's early and late upmix and the dual-band decode (no zone fading
    between two parameter sets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the band-split kernel has no CPU mode")
    cell = small_cell()
    with scene_built(cell, 2**31 + 43, "cuda") as (_, dev):
        for _ in range(2):
            al.alcRenderSamplesSOFT(dev, FRAMES)
        before = dev.band_split_launches
        blocks = dev.decode_blocks_dual
        al.alcRenderSamplesSOFT(dev, FRAMES)
        assert dev.decode_blocks_dual - blocks == BLOCKS
        assert dev.band_split_launches - before == 5 * BLOCKS
