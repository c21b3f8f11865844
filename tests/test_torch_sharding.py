"""The port's voice-axis sharding (parallel/sharding.py) on the CPU.

Each case spawns 2 or 4 ranks over gloo (a file store under the test's
temporary directory) and renders tests/test_sharding.py's scene through
``make_sharded_device_step``: one step, four carried blocks, and block-split
invariance (one 2T window against two carried T blocks), held to the
port's unsharded ``_render_one`` on the same inputs at that file's 2e-6
(one step) and 5e-6 (carried), with the carried per-voice state gathered
back (``pos_int`` exactly).  The four all-reduces reassociate float32 sums,
so the sharded and unsharded renders are not bit-equal above one rank.
Also: a UHJ2 voice whose rows straddle the shard boundary, a capacity equal
to the dry bus's width (first order: 4, where sharding by shape would cut
``direct_split``), a rank that fails, the dry run, and once the port's
2-rank step against the JAX package's step over a 2-device CPU mesh at
1e-4 (the slots' and filters' bound since the filtered slice: XLA:CPU
fuses FMAs).

The rank functions live here at module level: a spawned rank imports this
module, which imports no JAX.
"""

import time

import numpy as np
import pytest
import torch

from openal_soft_tpu_torch.parallel import sharding as sh

T = 256
STEP_TOL = 2e-6
CARRY_TOL = 5e-6
JAX_TOL = 1e-4
STATE_KEYS = ("filter_z", "hrtf_history", "hrtf_tail")


def _scene(loopback, capacity: int, effect: str = "echo", seed: int = 1,
           uhj_at: int | None = None, **kw):
    """tests/test_sharding.py's scene: HRTF stereo at 48 kHz, capacity - 1
    looping 220 Hz voices at pitch 2**U(-0.5, 0.5) sending to one slot;
    with ``uhj_at``, the voice at that index is a UHJ2 bed instead (its
    three rows start at the row the mono voices before it leave free)."""
    dev = loopback(frequency=48000, channels="stereo", sample_type="float32",
                   capacity=capacity, hrtf=True, **kw)
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect(effect))
    rng = np.random.default_rng(seed)
    t = np.arange(9600) / 48000.0
    buf = ctx.create_buffer()
    buf.set_data((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
                 "mono", "float32", 48000)
    n = capacity - 1
    if uhj_at is not None:
        uhj = ctx.create_buffer()
        uhj.set_data(np.stack([0.3 * np.sin(2 * np.pi * 330 * t),
                               0.25 * np.sin(2 * np.pi * 550 * t + 1.0)],
                              axis=1).ravel().astype(np.float32),
                     "uhj2", "float32", 48000)
        n = capacity - 3
    for i in range(n):
        src = ctx.create_source()
        if i == uhj_at:
            src.buffer(uhj)
        else:
            src.buffer(buf)
            src.set("position", tuple(rng.standard_normal(3) * 2.0))
            src.set("pitch", float(2.0 ** rng.uniform(-0.5, 0.5)))
            src.send(slot, 0)
        src.looping = True
        src.play()
    return dev


def _port_scene(capacity, effect="echo", seed=1, uhj_at=None):
    from openal_soft_tpu_torch.alc.device import LoopbackDevice

    return _scene(LoopbackDevice, capacity, effect, seed, uhj_at,
                  device="cpu")


def _np(tree: dict, keys=None) -> dict:
    """The tensor entries of a tree (``keys`` of them) as numpy."""
    return {k: v.cpu().numpy() for k, v in tree.items()
            if torch.is_tensor(v) and (keys is None or k in keys)}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        _same(v, b[k]) if isinstance(v, dict) else torch.equal(v, b[k])
        for k, v in a.items())


def _unsharded(dev, step, state, ev, cfg, pool, n_blocks: int, any_fade):
    """The port's single-process graph on the same (cloned) inputs, with
    the sharded step's plan, gates and fade flag."""
    st, e = sh._clone(state), sh._clone(ev)
    outs = [dev._render_one(st, e, cfg, pool, step.T, step.kind,
                            any_fade and b == 0, step.gates).cpu().numpy()
            for b in range(n_blocks)]
    return np.concatenate(outs, axis=-1), st, e


def _carried_rank(rank, world, group, capacity, effect, seed, n_blocks,
                  uhj_at=None):
    """n_blocks carried sharded blocks, the state gathered back, and on
    rank 0 the unsharded blocks; the inputs must come back unchanged."""
    torch.set_num_threads(1)
    dev = _port_scene(capacity, effect, seed, uhj_at)
    state, ev, cfg, pool = sh.device_step_inputs(dev, T)
    before = sh._clone(state), sh._clone(ev)
    step = sh.make_sharded_device_step(dev, group, T)
    any_fade = step.any_fade
    st, e, c = sh.shard_inputs(state, ev, cfg, rank, world)
    outs = []
    for _ in range(n_blocks):
        o, st, e = step(st, e, c, pool)
        outs.append(o.cpu().numpy())
    st, e = sh.gather_voices(st, group), sh.gather_voices(e, group)
    res = {"out": np.concatenate(outs, axis=-1),
           "state": _np(st), "ev": _np(e),
           "shard_keys": {k: tuple(v.shape) for k, v in
                          sh.shard_inputs(state, ev, cfg, rank, world)[0]
                          .items() if not isinstance(v, dict)},
           "unchanged": _same(before[0], state) and _same(before[1], ev),
           "uhj_rows": [r for v in dev._uhj_groups["u2"] for r in v.rows],
           "n_dry": dev.n_dry}
    if rank == 0:
        ref, rst, rev = _unsharded(dev, step, state, ev, cfg, pool,
                                   n_blocks, any_fade)
        res.update(ref=ref, ref_state=_np(rst), ref_ev=_np(rev))
    if world == 4:
        # A capacity that does not divide into the shards is refused.
        from openal_soft_tpu_torch.alc.device import LoopbackDevice

        odd = LoopbackDevice(capacity=6, device="cpu")
        sh.device_step_inputs(odd, T)
        try:
            sh.make_sharded_device_step(odd, group, T)
            res["refused"] = False
        except ValueError:
            res["refused"] = True
    return res


def _run(tmp_path, world, fn, *args):
    return sh.run_ranks(world, fn, args, backend="gloo", device="cpu",
                        init_method=f"file://{tmp_path}/store", timeout=240)


def _check_carried(res, tol):
    r0 = res[0]
    for r in res[1:]:
        # Every rank renders the same output (the sums are whole on each).
        assert np.array_equal(r["out"], r0["out"])
        assert r["unchanged"]
    assert r0["unchanged"]
    assert np.isfinite(r0["out"]).all() and np.abs(r0["out"]).max() > 1e-3
    assert np.abs(r0["out"] - r0["ref"]).max() <= tol
    for k in STATE_KEYS:
        assert np.abs(r0["state"][k] - r0["ref_state"][k]).max() <= tol, k
    assert np.array_equal(r0["ev"]["pos_int"], r0["ref_ev"]["pos_int"])
    for k in ("pos_frac", "has_wrapped", "fade"):
        assert np.array_equal(r0["ev"][k], r0["ref_ev"][k]), k


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_flagship_step(tmp_path, world):
    """One sharded block == the unsharded block (2e-6), per-voice state
    included; a capacity the ranks do not divide is refused."""
    res = _run(tmp_path, world, _carried_rank, 4 * world, "echo", 1, 1)
    _check_carried(res, STEP_TOL)
    if world == 4:
        assert all(r["refused"] for r in res)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_multiblock_carried_state(tmp_path, world):
    """Four carried sharded blocks == four unsharded blocks (5e-6)."""
    res = _run(tmp_path, world, _carried_rank, 16, "eaxreverb", 3, 4)
    _check_carried(res, CARRY_TOL)


def _split_rank(rank, world, group):
    torch.set_num_threads(1)
    dev = _port_scene(16, "eaxreverb", 5)
    state, ev, cfg, pool = sh.device_step_inputs(dev, T)
    step = sh.make_sharded_device_step(dev, group, T)
    st, e, c = sh.shard_inputs(state, ev, cfg, rank, world)
    # Warm one block: gain ramps span one call, so the invariance holds
    # from the converged state on.
    _, st0, e0 = step(st, e, c, pool)
    outs, st, e = [], st0, e0
    for _ in range(2):
        o, st, e = step(st, e, c, pool)
        outs.append(o.cpu().numpy())
    wide = sh.make_sharded_device_step(dev, group, 2 * T)
    wide.any_fade = False
    outw, stw, _ = wide(st0, e0, c, pool)
    st, stw = sh.gather_voices(st, group), sh.gather_voices(stw, group)
    return {"out": np.concatenate(outs, axis=-1), "outw": outw.numpy(),
            "state": _np(st, STATE_KEYS), "statew": _np(stw, STATE_KEYS)}


def test_sharded_block_split_invariance(tmp_path):
    """One sharded 2T window == two carried sharded T blocks (5e-6)."""
    r0 = _run(tmp_path, 2, _split_rank)[0]
    assert np.abs(r0["outw"] - r0["out"]).max() <= CARRY_TOL
    for k in ("filter_z", "hrtf_tail"):
        assert np.abs(r0["statew"][k] - r0["state"][k]).max() <= CARRY_TOL


def test_sharded_uhj_rows_straddle_the_shards(tmp_path):
    """A UHJ2 voice on rows 7-9 of two 8-row shards: each shard gathers
    its rows, the sum assembles the voice, every shard decodes it and
    writes back its own rows; four carried blocks (5e-6), the decode
    state whole and equal on every rank."""
    res = _run(tmp_path, 2, _carried_rank, 16, "eaxreverb", 2, 4, 7)
    assert res[0]["uhj_rows"] == [7, 8, 9]
    _check_carried(res, CARRY_TOL)
    for k in res[0]["ref_state"]:
        if k.startswith("uhj_"):
            for r in res:
                assert np.abs(r["state"][k]
                              - res[0]["ref_state"][k]).max() <= CARRY_TOL


def test_sharded_capacity_equal_to_dry_bus_width(tmp_path):
    """Capacity 4 == n_dry (first order): direct_split [4, 3], hrtf_tail
    and the reverb's lines stay whole on each shard (by name, not by
    shape), and the render matches the unsharded one."""
    res = _run(tmp_path, 2, _carried_rank, 4, "eaxreverb", 1, 4)
    r0 = res[0]
    assert r0["n_dry"] == 4
    assert r0["shard_keys"]["direct_split"] == (4, 3)
    assert r0["shard_keys"]["hrtf_tail"] == (128, 2)
    assert r0["shard_keys"]["filter_z"] == (2, 2, 2)
    _check_carried(res, CARRY_TOL)
    assert np.abs(r0["state"]["direct_split"]
                  - r0["ref_state"]["direct_split"]).max() <= CARRY_TOL


def _failing_rank(rank, world, group):
    if rank == 1:
        raise RuntimeError("rank 1 gives up before the all-reduce")
    torch.distributed.all_reduce(torch.ones(4), group=group)


def test_failed_rank_raises(tmp_path):
    """A rank that fails ends the run at once, with its traceback; the
    rank left waiting in the all-reduce is ended."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        _run(tmp_path, 2, _failing_rank)
    assert time.monotonic() - t0 < 60


def test_dryrun_multichip_on_the_cpu():
    """The dry run at 2 ranks against 1, its UHJ2 rows across the shards'
    boundary."""
    s = sh.dryrun_multichip(2, device="cpu", backend="gloo")
    half = s["capacity"] // 2
    assert min(s["uhj_rows"]) < half <= max(s["uhj_rows"])
    assert s["max_abs_err"] <= sh.DRYRUN_TOL and s["peak"] > 1e-3


def _jax_pair_rank(rank, world, group):
    torch.set_num_threads(1)
    dev = _port_scene(8, "echo", 1)
    state, ev, cfg, pool = sh.device_step_inputs(dev, T)
    step = sh.make_sharded_device_step(dev, group, T)
    out, st, e = step(*sh.shard_inputs(state, ev, cfg, rank, world), pool)
    st, e = sh.gather_voices(st, group), sh.gather_voices(e, group)
    return {"out": out.numpy(), "filter_z": st["filter_z"].numpy(),
            "pos_int": e["pos_int"].numpy()}


def test_sharded_step_matches_jax(tmp_path):
    """The port's 2-rank step against the JAX package's step over a
    2-device CPU mesh, on the echo scene at capacity 8 (1e-4)."""
    import jax
    from jax.sharding import Mesh

    from openal_soft_tpu.alc.device import LoopbackDevice as JaxLoopback
    from openal_soft_tpu.parallel import sharding as jsh

    port = _run(tmp_path, 2, _jax_pair_rank)[0]
    cpus = jax.devices("cpu")
    if len(cpus) < 2:
        pytest.fail("the JAX package's CPU platform has one device: "
                    "tests/conftest.py asks XLA for eight")
    dev = _scene(JaxLoopback, 8, "echo", 1)
    state, ev, cfg, pool = jsh.device_step_inputs(dev, T)
    mesh = Mesh(np.array(cpus[:2]), (jsh.VOICE_AXIS,))
    step = jsh.make_sharded_device_step(dev, mesh, T)(state, ev, cfg, pool)
    out, new_state, new_ev = step(state, ev, cfg, pool)
    assert np.abs(port["out"] - np.asarray(out)).max() <= JAX_TOL
    assert np.abs(port["filter_z"]
                  - np.asarray(new_state["filter_z"])).max() <= JAX_TOL
    assert np.array_equal(port["pos_int"], np.asarray(new_ev["pos_int"]))
