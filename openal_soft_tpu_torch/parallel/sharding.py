"""Voice-axis sharding of the render graph over a torch.distributed group
(port of parallel/sharding.py).

The voice population is structure-of-arrays, so scaling across cards is
one-axis data parallelism over the per-block graph
(``RenderDevice._render_one``): each rank renders its shard of the voice
rows through resample -> UHJ decode -> filters -> mix -> HRTF, with every
row's carried state (filter memories, HRTF history, NFC memories) beside
it.  The graph's four cross-voice sums (the UHJ rows gathered for the
decode, the dry ambisonic bus, the wet slot buses and the voices' HRTF
accumulation) become all-reduces over the group, the only collectives; the
stages after them (the effects, the decode, the HRTF fold) run on every
rank alike, so their state stays whole on each.

The group and the device are the caller's: NCCL with one rank per card,
gloo on the CPU, gloo on CUDA tensors for several ranks on one card.
Nothing picks another backend or renders unsharded when a collective
fails: the error propagates.

    python -m openal_soft_tpu_torch.parallel.sharding [WORLD] [--device cpu]
        [--backend gloo]

runs ``dryrun_multichip``: by default one rank per card over NCCL; two
ranks on one card take ``--backend gloo``, the CPU ``--device cpu
--backend gloo`` (WORLD 2 by default).
"""

from __future__ import annotations

import datetime
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import ParamTable

VOICE_AXIS = "voices"

# The inputs that hold one row per voice line, by name: the param table's
# fields and the device's per-row uploads and carried memories.  Everything
# else (the pool, the effect slots, the decoders' and the HRTF fold's
# state, the UHJ decode state, which is per UHJ voice) is whole on every
# rank.  A leading dimension equal to the capacity does not make an array
# per-voice: ``direct_split`` is [n_dry, 3] and ``hrtf_tail`` [128, 2].
PER_VOICE = frozenset(ParamTable._EVOLVING + ParamTable._CONFIG + (
    "rs_unit_w", "nfc_coeffs", "reset_rows", "filter_z", "send_filter_z",
    "hrtf_history", "nfc_z"))


def device_step_inputs(dev, T: int):
    """(state, ev, cfg, pool) of a live device for a sharded step, every
    row, uploaded as its render loop uploads them.  ``T`` is unused (the
    JAX package's signature)."""
    with dev.lock:
        for ctx in dev.contexts:
            ctx.process_updates()
        ev, _ = dev._upload()
        return (dev._state, ev, dev._cfg_dev,
                dev.pool.device_array(dev.torch_device))


def shard_inputs(state: dict, ev: dict, cfg: dict, rank: int, world: int):
    """This rank's (state, ev, cfg): the rows [rank*V, (rank+1)*V) of every
    per-voice entry (views), the rest as given.  cfg also gains, per UHJ
    kind, which of the kind's gathered rows this shard owns
    (``uhj_own_*``) and where they lie in the shard (``uhj_local_*``)."""
    L = cfg["active"].shape[0]
    if L % world:
        raise ValueError(f"capacity {L} does not divide into {world} shards")
    V = L // world
    lo = rank * V

    def cut(tree):
        return {k: v[lo:lo + V] if k in PER_VOICE else v
                for k, v in tree.items()}

    cfg_s = cut(cfg)
    for key, rows in cfg.items():
        if not key.startswith("uhj_rows_"):
            continue
        kind = key[len("uhj_rows_"):]
        r = rows.cpu()
        own = torch.nonzero((r >= lo) & (r < lo + V)).flatten()
        cfg_s[f"uhj_own_{kind}"] = own.to(rows.device)
        cfg_s[f"uhj_local_{kind}"] = (r[own] - lo).to(rows.device)
    return cut(state), cut(ev), cfg_s


def gather_voices(tree: dict, group=None) -> dict:
    """The per-voice entries of a shard's tree gathered over the group
    (every row, in rank order); the other entries as this rank holds
    them."""
    world = dist.get_world_size(group)
    out = {}
    for k, v in tree.items():
        if k not in PER_VOICE:
            out[k] = v
            continue
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(world)]
        dist.all_gather(parts, v, group=group)
        out[k] = torch.cat(parts)
    return out


def _clone(tree: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


class ShardedStep:
    """One block of the device's graph over this rank's shard (see
    ``make_sharded_device_step``).  ``any_fade`` is the host's knowledge
    that some row fades in the next block: the table's, then False, since
    a block ends every fade (the device's render loop keeps the same)."""

    def __init__(self, dev, group, T: int) -> None:
        if dev._cfg_dev is None:
            raise RuntimeError("the device's config is not uploaded: call "
                               "device_step_inputs first")
        self.world = dist.get_world_size(group)
        if dev.capacity % self.world:
            raise ValueError(f"capacity {dev.capacity} does not divide into "
                             f"{self.world} shards")
        self.dev, self.group, self.T = dev, group, T
        # Host-known facts of the whole table, alike on every rank, so every
        # rank takes the same branches and meets the same collectives.
        self.kind, _ = dev._rs_plan(T, 1)
        self.gates = dev._graph_gates()
        self.any_fade = bool(dev.table.fade.any())

    def _reduce(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.group)

    def __call__(self, state: dict, ev: dict, cfg: dict, pool):
        V = self.dev.capacity // self.world
        if cfg["active"].shape[0] != V:
            raise ValueError(f"inputs hold {cfg['active'].shape[0]} rows, "
                             f"a shard {V}: pass shard_inputs(...)")
        state, ev = _clone(state), _clone(ev)
        out = self.dev._render_one(state, ev, cfg, pool, self.T, self.kind,
                                   self.any_fade, self.gates,
                                   reduce=self._reduce)
        self.any_fade = False
        return out, state, ev


def make_sharded_device_step(dev, group=None, T: int = 1024) -> ShardedStep:
    """The device's block graph over this rank's shard of the voice rows.

    Returns f(state, ev, cfg, pool) -> (out [n_real, T], new_state, new_ev)
    taking ``shard_inputs`` of ``device_step_inputs``; out is whole on
    every rank, new_state and new_ev are the shard's (``gather_voices``
    assembles them).  The inputs are not mutated, so feeding (new_state,
    new_ev) back renders consecutive blocks with carried state.  Build it
    after ``device_step_inputs``: the resampler plan, the graph's gates
    and the fade flag come from the device's whole table."""
    return ShardedStep(dev, group, T)


# --- ranks -------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, backend: str, device: str,
               init_method: str, timeout_s: float, fn, args, results) -> None:
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_ranks(world: int, fn, args: tuple = (), *, backend: str,
              device: str, timeout: float = 600.0,
              init_method: str | None = None) -> list:
    """fn(rank, world, group, *args) in ``world`` spawned processes, one
    process group over them (``backend`` on ``device``: on the card, rank r
    uses card r mod the card count).  Returns the results in rank order;
    they travel pickled, so return numpy or plain values.  Raises, with the
    rank's traceback, as soon as a rank fails, and when ``timeout`` seconds
    pass; every process is ended before it returns."""
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank per card: {world} ranks on "
                         f"{torch.cuda.device_count()} cards (pass "
                         "backend='gloo' for several ranks on one card)")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = init_method or f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, backend, device, init_method,
                               timeout, fn, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    done: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    late = sorted(set(range(world)) - set(done))
                    raise TimeoutError(f"ranks {late} did not finish in "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            done[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(done) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    return [done[r] for r in range(world)]


# --- the multi-rank dry run --------------------------------------------------

def dryrun_scene(world: int, device: str = "cuda"):
    """__graft_entry__.dryrun_multichip's scene on the port: HRTF stereo at
    48 kHz, max(8*world, 64) voice rows (a multiple of world), pitched
    looping voices sending to one EAXReverb slot, and a UHJ2 voice whose
    three rows straddle the first shard boundary (rows V-1, V, V+1 of
    shards of V rows; the last voice at world 1)."""
    from ..alc.device import LoopbackDevice

    capacity = -(-max(8 * world, 64) // world) * world
    dev = LoopbackDevice(frequency=48000, channels="stereo",
                         sample_type="float32", capacity=capacity,
                         hrtf=True, device=device)
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("eaxreverb"))
    rng = np.random.default_rng(0)
    t = np.arange(12000) / 48000.0
    buf = ctx.create_buffer()
    buf.set_data((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
                 "mono", "float32", 48000)
    uhjbuf = ctx.create_buffer()
    uhjbuf.set_data(np.stack([0.3 * np.sin(2 * np.pi * 330 * t),
                              0.25 * np.sin(2 * np.pi * 550 * t + 1.0)],
                             axis=1).ravel().astype(np.float32),
                    "uhj2", "float32", 48000)
    n_mono = capacity - 4
    uhj_at = capacity // world - 1 if world > 1 else n_mono
    for i in range(n_mono + 1):
        src = ctx.create_source()
        if i == uhj_at:
            src.buffer(uhjbuf)
        else:
            src.buffer(buf)
            src.set("position", tuple(rng.standard_normal(3) * 3.0))
            src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
            src.send(slot, 0)
        src.looping = True
        src.play()
    return dev


_DRYRUN_T = 256
_DRYRUN_BLOCKS = 8
DRYRUN_TOL = 5e-6


def _render_blocks(step, state, ev, cfg, pool, n: int) -> np.ndarray:
    outs = []
    for _ in range(n):
        out, state, ev = step(state, ev, cfg, pool)
        outs.append(out.cpu().numpy())
    return np.concatenate(outs, axis=-1)


def _dryrun_rank(rank: int, world: int, group, device: str) -> dict:
    dev = dryrun_scene(world, device)
    T, NB = _DRYRUN_T, _DRYRUN_BLOCKS
    state, ev, cfg, pool = device_step_inputs(dev, T)
    step = make_sharded_device_step(dev, group, T)
    full = _render_blocks(step, *shard_inputs(state, ev, cfg, rank, world),
                          pool, NB)
    # The same carried horizon over half the ranks (world 1: unsharded).
    half = world // 2
    sub = dist.new_group(list(range(half))) if half else None
    if half and rank < half:
        steph = make_sharded_device_step(dev, sub, T)
        ref = _render_blocks(steph, *shard_inputs(state, ev, cfg, rank, half),
                             pool, NB)
    elif not half:
        st, e = _clone(state), _clone(ev)
        any_fade = bool(dev.table.fade.any())
        refs = []
        for b in range(NB):
            refs.append(dev._render_one(st, e, cfg, pool, T, step.kind,
                                        any_fade and b == 0, step.gates)
                        .cpu().numpy())
        ref = np.concatenate(refs, axis=-1)
    else:
        ref = None
    return {"out": full, "ref": ref, "capacity": dev.capacity,
            "uhj_rows": [r for v in dev._uhj_groups["u2"] for r in v.rows]}


def dryrun_multichip(world: int, device: str = "cuda",
                     backend: str = "nccl") -> dict:
    """``world`` ranks render 8 carried 256-frame blocks of ``dryrun_scene``
    over the voice axis, and the first world // 2 ranks render the same
    blocks over half the ranks (world 1: the unsharded graph); the two must
    agree within 5e-6, as the JAX package's dry run asks of its two
    meshes.  Returns the summary it prints."""
    res = run_ranks(world, _dryrun_rank, (device,), backend=backend,
                    device=device)
    full, ref = res[0]["out"], res[0]["ref"]
    if not np.isfinite(full).all():
        raise AssertionError("dryrun_multichip: the output is not finite")
    for r in res[1:]:
        if not np.array_equal(r["out"], full):
            raise AssertionError("dryrun_multichip: the ranks' outputs "
                                 "differ")
    err = float(np.abs(full - ref).max())
    if not err <= DRYRUN_TOL:
        raise AssertionError(
            f"{_DRYRUN_BLOCKS}x{_DRYRUN_T} carried blocks: {world} ranks vs "
            f"{max(world // 2, 1)} deviate by {err}")
    summary = {"world": world, "backend": backend, "device": device,
               "capacity": res[0]["capacity"],
               "uhj_rows": res[0]["uhj_rows"], "shape": list(full.shape),
               "peak": float(np.abs(full).max()), "max_abs_err": err}
    print(f"dryrun_multichip OK: {summary}", flush=True)
    return summary


if __name__ == "__main__":
    argv = sys.argv[1:]
    opt = lambda name, default: (argv[argv.index(name) + 1]  # noqa: E731
                                 if name in argv else default)
    device = opt("--device", "cuda")
    world = (int(argv[0]) if argv and argv[0].isdigit()
             else torch.cuda.device_count() if device == "cuda" else 2)
    dryrun_multichip(world, device=device, backend=opt("--backend", "nccl"))
