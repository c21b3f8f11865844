"""The metric arithmetic, on hand-made records of a traced run."""

import math

import pytest

from harness import reduce, registry, trace


def rec(device_ops, blocks=4, unprof_blocks=8, unprof_wall=0.08,
        voices=4096, source_bytes=0.0, spans=None, taps=64, products=None):
    return {"loop": "batch", "device_ops": device_ops, "host": [],
            "products": products or {},
            "slice": {"calls": 1, "blocks": blocks, "frames": blocks * 1024,
                      "wall_s": 0.05},
            "unprofiled": {"calls": 2, "blocks": unprof_blocks,
                           "wall_s": unprof_wall, "spans": spans or {}},
            "work": {"voices": voices, "source_bytes": source_bytes,
                     "hrir_taps": taps}}


def read(name, r):
    return registry.load_module("metrics", name).read(r)


def test_rates_cover_the_whole_window():
    calls = [(10.0, 10.5), (10.5, 11.0), (11.0, 13.0)]
    # 3 calls of 48000 frames at 48 kHz: 3 s of audio over 3 s of wall.
    assert reduce.realtime_x(calls, 48000, 48000) == pytest.approx(1.0)
    # A slow last call counts in full: 4 s of audio over 5 s of wall.
    calls.append((13.0, 15.0))
    assert reduce.realtime_x(calls, 48000, 48000) == pytest.approx(0.8)


def test_busy_is_the_union_not_the_sum():
    ops = [("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 300.0, 400.0)]
    assert reduce.union_s([(s, e) for _, s, e in ops]) == pytest.approx(
        250e-6)
    assert reduce.gaps([(s, e) for _, s, e in ops], 0.0, 500.0) == [
        (150.0, 300.0), (400.0, 500.0)]


def test_idle_and_launches():
    ops = [("k", 0.0, 10000.0), ("k", 5000.0, 20000.0)]   # 20 ms busy
    r = rec(ops, blocks=4, unprof_blocks=8, unprof_wall=0.08)
    # 5 ms busy a block against 10 ms of wall a block.
    assert read("idle_pct.batch", r) == pytest.approx(50.0)
    assert read("launches_per_block.batch", r) == pytest.approx(0.5)


def test_resample_roofline():
    V, blocks = 4096, 16
    frames = blocks * 1024
    nbytes = 4.0 * V * frames + 1e6
    t = nbytes / 3.35e12 / 0.5                 # half the byte rate
    r = rec([("void rsw::window_kernel<4>(float const*)", 0.0, t * 1e6),
             ("other", 0.0, 1e6)], blocks=blocks, voices=V,
            source_bytes=1e6)
    assert read("resample_roofline_pct", r) == pytest.approx(50.0)
    assert read("resample_roofline_pct", rec([("other", 0.0, 5.0)])) is None


def test_hrtf_roofline_against_tf32_and_bytes():
    V, frames = 4096, 16384
    flops = 2 * 2 * 64 * V * frames
    nbytes = 4 * (V * frames + 2 * frames)
    bound = max(flops / 495e12, nbytes / 3.35e12)
    assert bound == pytest.approx(nbytes / 3.35e12)     # bytes bound it
    assert reduce.hrtf_bound_s(V, frames, 64) == pytest.approx(bound)
    t = 10 * bound
    # A product over 9 ambisonic channels is not the contraction.
    r = rec([("cutlass_80_simt_sgemm_256x128", 0.0, 2 * t * 1e6)],
            blocks=16, voices=V, products={V: t, 9: t})
    assert read("hrtf_roofline_pct", r) == pytest.approx(10.0)
    assert read("hrtf_roofline_pct", rec([], products={9: t})) is None
    assert read("hrtf_roofline_pct", rec([])) is None


def test_compute_bound_hrtf_share_uses_the_set_taps():
    # One voice: 2 x 2 x taps operations a frame outweigh its bytes only
    # when the tap count is large; the bound follows the set's taps.
    assert reduce.hrtf_bound_s(4096, 1024, 128) == pytest.approx(
        max(4 * 128 * 4096 * 1024 / 495e12, 4 * 4098 * 1024 / 3.35e12))


@pytest.mark.parametrize("name,shapes,inner", [
    ("aten::mm", [[384, 4096], [4096, 16448]], 4096),
    ("aten::bmm", [[2, 192, 4096], [2, 4096, 64]], 4096),
    ("aten::addmm", [[384], [384, 9], [9, 1088]], 9),
    ("aten::add", [[2, 8], [2, 8]], None),
    ("aten::mm", [], None),
])
def test_product_ops_give_their_contracted_size(name, shapes, inner):
    assert trace._inner(name, shapes) == inner


def test_breakdown_labels_gaps_by_host_span():
    r = rec([("k1", 0.0, 100.0), ("k2", 400.0, 500.0), ("k1", 900.0, 1000.0)])
    r["host"] = [("render_call", 0.0, 600.0), ("aten::copy_", 150.0, 350.0),
                 ("render_call", 700.0, 1000.0)]
    bd = trace.breakdown(r)
    assert bd["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["render_call/aten::copy_"] == pytest.approx(300e-6)
    assert gaps["render_call"] == pytest.approx(400e-6)
    assert math.isclose(sum(gaps.values()), 700e-6)
