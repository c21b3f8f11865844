"""Port tests that need the card (marker ``cuda``); they skip without one.

Run them on a machine with an NVIDIA GPU, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which a machine set
up for the port need not have.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from openal_soft_tpu_torch.ops.kernels import biquad as t_biq
from openal_soft_tpu_torch.ops.kernels import resample_gen as t_gen
from openal_soft_tpu_torch.ops.kernels import resample_unit as t_unit
from openal_soft_tpu_torch.ops.kernels import reverb as t_rev

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("taps", [4, 24, 48])
@pytest.mark.parametrize("W", [128, 1024, 16384])
def test_unit_kernel_equals_plain_version(cuda, taps, W):
    args = chip_smoke.unit_case(np.random.default_rng(taps * W), 256, W,
                                taps, cuda)
    before = t_unit.resample_unit.launches
    got = t_unit.resample_unit(*args, W)
    torch.cuda.synchronize()
    assert t_unit.resample_unit.launches == before + 1
    assert torch.equal(got, t_unit.resample_unit_ref(*args, W))


def test_wrapper_rejects_bad_inputs(cuda):
    args = list(chip_smoke.unit_case(np.random.default_rng(0), 8, 128, 4,
                                     cuda))
    args[-1] = args[-1].double()                   # weights must be f32
    with pytest.raises(TypeError):
        t_unit.resample_unit(*args, 128)


def test_port_on_the_card_matches_the_cpu(cuda):
    g = chip_smoke.bench_scene(64, 64, "cuda")
    c = chip_smoke.bench_scene(64, 64, "cpu")
    before = t_unit.resample_unit.launches
    for n in (8192, 4096, 100):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= chip_smoke.PARITY_TOL
    assert t_unit.resample_unit.launches > before


@pytest.mark.parametrize("taps", [1, 2, 4, 24, 48])
@pytest.mark.parametrize("W", [128, 16384])
def test_general_kernel_equals_plain_version(cuda, taps, W):
    args = chip_smoke.gen_case(np.random.default_rng(taps + W), 256, W, taps,
                               10 << 16, cuda)
    before = t_gen.resample_gen.launches
    got = t_gen.resample_gen(*args, W, taps)
    torch.cuda.synchronize()
    assert t_gen.resample_gen.launches == before + 1
    assert torch.equal(got, t_gen.resample_gen_ref(*args, W, taps))


@pytest.mark.parametrize("rate", [48000, 96000])
@pytest.mark.parametrize("crossfade", [False, True])
def test_reverb_kernel_within_bound_of_plain_version(cuda, rate, crossfade):
    eff, prm, st = chip_smoke.reverb_case(rate, crossfade, "cuda")
    st_plain = {k: (v.clone() if isinstance(v, torch.Tensor) else
                    {n: t.clone() for n, t in v.items()})
                for k, v in st.items()}
    windows = chip_smoke.reverb_windows(np.random.default_rng(rate), 1024,
                                        eff.chunk, cuda)
    got = chip_smoke.run_reverb_windows(eff, prm, st, windows, True)
    want = chip_smoke.run_reverb_windows(eff, prm, st_plain, windows, False)
    torch.cuda.synchronize()
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) \
        <= chip_smoke.REVERB_TOL


def test_loaded_scene_on_the_card_matches_the_cpu(cuda):
    g = chip_smoke.bench_scene(64, 64, "cuda", loaded=True)
    c = chip_smoke.bench_scene(64, 64, "cpu", loaded=True)
    before = (t_gen.resample_gen.launches, t_rev.reverb_pipeline.launches)
    for n in (8192, 4096, 100):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= chip_smoke.LOADED_TOL
    assert t_gen.resample_gen.launches > before[0]
    assert t_rev.reverb_pipeline.launches > before[1]


@pytest.mark.parametrize("counters", ["0", "256", "mixed"])
@pytest.mark.parametrize("V,T", [(100, 128), (256, 1024), (64, 16384)])
def test_biquad_kernel_equals_plain_version(cuda, V, T, counters):
    args = chip_smoke.biquad_case(np.random.default_rng(V + T), V, T,
                                  counters, cuda)
    before = t_biq.biquad_dual.launches
    got = t_biq.biquad_dual(*args)
    torch.cuda.synchronize()
    assert t_biq.biquad_dual.launches == before + 1
    for a, b in zip(got, t_biq.biquad_dual_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scene", list(chip_smoke.SPEAKER_SCENES))
def test_filtered_scene_on_the_card_matches_the_cpu(cuda, scene):
    g = chip_smoke.speaker_scene(scene, 64, "cuda")
    c = chip_smoke.speaker_scene(scene, 64, "cpu")
    before = t_biq.biquad_dual.launches
    for n in (8192, 4096, 100):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= chip_smoke.SPEAKERS_TOL
    assert t_biq.biquad_dual.launches > before
