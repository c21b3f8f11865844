"""The host mirror's end-of-chunk advance (``Context.finish_chunk``).

``finish_chunk`` advances the static voices without an event in one numpy
step and runs the per-voice path only for the others; it copies ramps and
advances interp schedules only on rows with something pending.  Here it is
held bit for bit to the per-voice advance it replaced, kept below as
``per_voice_finish_chunk``: on random voice populations against a stub
device, and through the AL API on a CPU device, where the rendered output,
the events, the source states and the offsets must match too.
"""

import numpy as np
import pytest

from openal_soft_tpu_torch.al import api as al
from openal_soft_tpu_torch.alc.context import Context
from openal_soft_tpu_torch.constants import (MAX_PITCH, MIXER_FRAC_BITS,
                                             MIXER_FRAC_MASK)
from openal_soft_tpu_torch.core.device import ParamTable
from openal_soft_tpu_torch.core.voice import BufferItem, PlayState
from openal_soft_tpu_torch.ops import filters as f_ops


def per_voice_finish_chunk(self, T: int, n_blocks: int = 1) -> None:
    """The per-voice ``Context.finish_chunk``: every playing voice through
    ``Voice.advance`` in a Python loop, every playing row's ramp copied and
    interp schedule advanced."""
    t = self.device.table
    frames = T * n_blocks
    playing_rows: list[int] = []
    for v in self.voices:
        if not v.rows:
            continue
        if v.state == PlayState.STOPPING:
            v.state = PlayState.STOPPED
            self.device.free_rows(v.rows)
            v.rows = []
            continue
        if v.state != PlayState.PLAYING:
            continue
        playing_rows.extend(v.rows)

        v.is_fading = True
        total = v.position_frac + v.step * frames
        samples_done = total >> MIXER_FRAC_BITS
        v.position_frac = total & MIXER_FRAC_MASK
        buffers_done, ended = v.advance(samples_done)
        if buffers_done:
            self._emit("buffer_completed", v.source_id, buffers_done)
            self.device.mark_config_dirty()
        if ended:
            v.state = PlayState.STOPPING
            self._emit("source_state", v.source_id, "stop")
            src = self.sources.get(v.source_id)
            if src is not None:
                src.voice_ended()
            v.source_id = 0
            self.device.mark_config_dirty()

    if not playing_rows:
        return
    rows = np.array(playing_rows, np.int64)
    pl = t.playing[rows]
    t.dry_cur[rows] = np.where(pl[:, None], t.dry_tgt[rows], 0.0)
    t.wet_cur[rows] = np.where(pl[:, None, None], t.wet_tgt[rows], 0.0)
    t.hrtf_old_gain[rows] = t.hrtf_gain[rows]
    t.hrtf_old_coeffs[rows] = t.hrtf_coeffs[rows]
    t.hrtf_old_delay[rows] = t.hrtf_delay[rows]
    cf, cnt = f_ops.host_advance_interp(
        t.filter_coeffs[rows], t.filter_target[rows],
        np.maximum(t.filter_counter[rows], 0),
        min(frames, f_ops.INTERP_SAMPLES))
    keep = t.filter_counter[rows] >= 0
    t.filter_coeffs[rows[keep]] = cf[keep]
    t.filter_counter[rows[keep]] = cnt[keep]
    for snd in range(self.device.num_aux_sends):
        scf, scnt = f_ops.host_advance_interp(
            t.send_filter_coeffs[rows, snd],
            t.send_filter_target[rows, snd],
            np.maximum(t.send_filter_counter[rows, snd], 0),
            min(frames, f_ops.INTERP_SAMPLES))
        keep = t.send_filter_counter[rows, snd] >= 0
        t.send_filter_coeffs[rows[keep], snd] = scf[keep]
        t.send_filter_counter[rows[keep], snd] = scnt[keep]


# --- random populations against a stub device ---------------------------------


class _StubDevice:
    """What finish_chunk touches of a RenderDevice: the table, the send
    count, the config key (dropped by a change, renewed by an upload as
    ``_render_dispatch`` does before each chunk) and the row frees."""

    def __init__(self, capacity: int, sends: int) -> None:
        self.contexts = []
        self.table = ParamTable(capacity, 2, sends, 4)
        self.num_aux_sends = sends
        self.dirtied = 0
        self.freed: list[list[int]] = []
        self._cfg_dev = object()

    def mark_config_dirty(self) -> None:
        self.dirtied += 1
        self._cfg_dev = None

    def free_rows(self, rows) -> None:
        for r in rows:
            self.table.clear_row(r)
        self.freed.append(list(rows))
        self._cfg_dev = None

    def upload(self) -> None:
        if self._cfg_dev is None:
            self._cfg_dev = object()


class _Source:
    def __init__(self, sid: int, log: list) -> None:
        self.sid, self.log = sid, log

    def voice_ended(self) -> None:
        self.log.append(self.sid)


KINDS = ("loop", "once", "stream", "inactive", "mixed")
CHUNKS = ((128, 1), (1024, 8), (256, 64), (512, 256), (1024, 512))


def _step(rng, i: int) -> int:
    """Unit steps, pitches up to MAX_PITCH, and their extremes."""
    return int([1 << 16, 1, MAX_PITCH << MIXER_FRAC_BITS,
                int(rng.integers(1, MAX_PITCH << MIXER_FRAC_BITS)),
                int(rng.integers(1 << 15, 1 << 17))][i % 5])


def _add_voice(ctx, rng, kind: str, i: int, frames: int, rows: list) -> None:
    v = ctx.new_voice()
    v.source_id = 100 + i
    v.state = PlayState.PLAYING
    v.step = _step(rng, i)
    v.position_frac = int(rng.integers(0, 1 << 16))
    v.rows = [rows.pop() for _ in range(int(rng.integers(1, 3)))]
    done = (v.position_frac + v.step * frames) >> MIXER_FRAC_BITS
    if kind == "loop":
        n = int(rng.integers(1, 200000))
        ls = int(rng.integers(0, n))
        le = int(rng.integers(ls + 1, n + 1)) if i % 7 else ls  # degenerate
        v.queue = [BufferItem(sample_len=n, loop_start=ls, loop_end=le)]
        v.looping = True
        v.position = int(rng.integers(0, n))
        v.has_wrapped = bool(rng.integers(0, 2))
    elif kind == "once":
        # Ends before, at, just after or long after the chunk's end.
        pos = int(rng.integers(0, 5000))
        n = pos + max(done + [-1, 0, 1, 1 << 20, -done][i % 5], 1)
        v.queue = [BufferItem(sample_len=n, loop_start=0, loop_end=n)]
        v.looping = False
        v.position = min(pos, n - 1)
    elif kind == "stream":
        # Completes 0, 1 or several buffers; looping queues wrap round.
        lens = [int(x) for x in rng.integers(1, max(done, 2) + 2000,
                                             int(rng.integers(1, 6)))]
        v.queue = [BufferItem(sample_len=n) for n in lens]
        v.is_stream = bool(i % 3)        # else one static-looking entry
        if not v.is_stream:
            v.queue = v.queue + [BufferItem(sample_len=lens[0])]
        v.looping = bool(i % 2)
        v.queue_index = int(rng.integers(0, len(v.queue)))
        v.position = int(rng.integers(0, v.queue[v.queue_index].sample_len))
    else:
        which = i % 5
        if which == 0:
            v.state = PlayState.STOPPING
            v.queue = [BufferItem(sample_len=1000)]
        elif which == 1:
            v.queue = []                          # no current buffer
        elif which == 2:
            v.queue = [BufferItem(sample_len=1000)]
            v.queue_index = 3                     # past the queue's end
        elif which == 3:
            v.queue = [BufferItem(sample_len=1 << 24, loop_end=1 << 24,
                                  callback=object())]
            v.looping = True
        else:
            v.state = [PlayState.STOPPED, PlayState.PENDING][i % 2]
            v.queue = [BufferItem(sample_len=1000)]
    ctx.sources[v.source_id] = _Source(v.source_id, ctx.ended)


def _fill_table(t: ParamTable, rng) -> None:
    """Random rows; a row whose ramp copy would move something is pending,
    as every writer of a target leaves it."""
    L = t.capacity
    for k in ParamTable._FIELDS:
        a = getattr(t, k)
        if a.dtype == bool:
            a[...] = rng.integers(0, 2, a.shape).astype(bool)
        elif a.dtype == np.float32:
            a[...] = rng.standard_normal(a.shape).astype(np.float32)
        else:
            a[...] = rng.integers(0, 200, a.shape)
    counters = np.array([-1, 0, 0, 32, 64, 96, 224, 256], np.int32)
    t.filter_counter[...] = rng.choice(counters, L)
    t.send_filter_counter[...] = rng.choice(counters, t.send_filter_counter.shape)
    settled = rng.integers(0, 2, L).astype(bool)
    pl = t.playing[settled]
    t.dry_cur[settled] = np.where(pl[:, None], t.dry_tgt[settled], 0.0)
    t.wet_cur[settled] = np.where(pl[:, None, None], t.wet_tgt[settled], 0.0)
    for new, old in (("hrtf_gain", "hrtf_old_gain"),
                     ("hrtf_coeffs", "hrtf_old_coeffs"),
                     ("hrtf_delay", "hrtf_old_delay")):
        getattr(t, old)[settled] = getattr(t, new)[settled]
    t.ramp_pending[...] = ~settled


def _population(kind: str, seed: int, frames: int, sends: int):
    rng = np.random.default_rng(seed)
    n = 48
    dev = _StubDevice(3 * n, sends)
    ctx = Context(dev)
    ctx.ended = []
    rows = [int(r) for r in rng.permutation(3 * n)]
    for i in range(n):
        k = KINDS[i % 4] if kind == "mixed" else kind
        _add_voice(ctx, rng, k, i, frames, rows)
    _fill_table(dev.table, rng)
    return dev, ctx


def _voice_fields(v) -> tuple:
    return (v.position, v.position_frac, v.queue_index, v.has_wrapped,
            v.state, v.source_id, v.is_fading, list(v.rows))


def _assert_same(dev_a, ctx_a, dev_b, ctx_b) -> None:
    assert [_voice_fields(v) for v in ctx_a.voices] == \
        [_voice_fields(v) for v in ctx_b.voices]
    assert ctx_a.events == ctx_b.events
    assert ctx_a.ended == ctx_b.ended
    assert dev_a.dirtied == dev_b.dirtied
    assert dev_a.freed == dev_b.freed
    for k in ParamTable._FIELDS:
        a, b = getattr(dev_a.table, k), getattr(dev_b.table, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("T,n_blocks", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_matches_per_voice_advance(kind, T, n_blocks):
    """Three chunks in a row (the second and third reuse the voice split
    unless a change dropped the config), each compared bit for bit."""
    seed = 7919 * KINDS.index(kind) + T + n_blocks
    frames = T * n_blocks
    sends = 1 + n_blocks % 2
    dev_a, ctx_a = _population(kind, seed, frames, sends)
    dev_b, ctx_b = _population(kind, seed, frames, sends)
    _assert_same(dev_a, ctx_a, dev_b, ctx_b)
    for _ in range(3):
        ctx_a.finish_chunk(T, n_blocks)
        per_voice_finish_chunk(ctx_b, T, n_blocks)
        _assert_same(dev_a, ctx_a, dev_b, ctx_b)
        dev_a.upload()
        dev_b.upload()
    assert ctx_a.mirror_voices_batched + ctx_a.mirror_voices_stepped > 0
    if kind in ("loop", "once", "mixed"):
        assert ctx_a.mirror_voices_batched > 0


def test_step_past_int32():
    """frac + step * frames passes 2**31 at 512 blocks and a high pitch;
    the batched step takes it in 64 bits, as Voice.advance's integers."""
    frames = 512 * 1024
    dev = _StubDevice(4, 0)
    ctx = Context(dev)
    v = ctx.new_voice()
    v.state, v.rows, v.looping = PlayState.PLAYING, [0], True
    v.step = MAX_PITCH << MIXER_FRAC_BITS
    v.position_frac = MIXER_FRAC_MASK
    v.queue = [BufferItem(sample_len=48000, loop_start=100, loop_end=48000)]
    total = v.position_frac + v.step * frames
    assert total >= 1 << 31
    ctx.finish_chunk(1024, 512)
    pos = total >> MIXER_FRAC_BITS
    assert ctx.mirror_voices_batched == 1
    assert v.position == (pos - 100) % (48000 - 100) + 100
    assert v.position_frac == total & MIXER_FRAC_MASK and v.has_wrapped


# --- through the AL API on a CPU device ------------------------------------------


RATE = 48000
BLOCK = 1024


def _tone(n: int, hz: float) -> np.ndarray:
    return (0.2 * np.sin(2 * np.pi * hz * np.arange(n) / RATE)
            ).astype(np.float32)


def _api_scene(loops: int, once_frames: int | None, scenario: str | None):
    dev = al.alcLoopbackOpenDeviceSOFT(RATE, "stereo", "float32",
                                       device="cpu", capacity=96)
    ctx = al.alcCreateContext(dev)
    al.alcMakeContextCurrent(ctx)
    loop_buf = al.alGenBuffers()
    al.alBufferData(loop_buf, al.AL_FORMAT_MONO_FLOAT32, _tone(2400, 220.0),
                    RATE)
    rng = np.random.default_rng(5)
    sources = []
    for i in range(loops):
        sid = al.alGenSources()
        al.alSourcei(sid, al.AL_BUFFER, loop_buf)
        al.alSourcei(sid, al.AL_LOOPING, 1)
        al.alSource3f(sid, al.AL_POSITION, *map(float, rng.normal(0, 3, 3)))
        al.alSourcef(sid, al.AL_PITCH, float(2.0 ** rng.uniform(-1, 1)))
        sources.append(sid)
    if once_frames is not None:
        once_buf = al.alGenBuffers()
        al.alBufferData(once_buf, al.AL_FORMAT_MONO_FLOAT32,
                        _tone(once_frames, 330.0), RATE)
        sid = al.alGenSources()
        al.alSourcei(sid, al.AL_BUFFER, once_buf)
        sources.append(sid)
    if scenario == "moves":
        # A lowpassed voice (interp schedules pending) and a stream.
        flt = al.alGenFilters()
        al.alFilteri(flt, al.AL_FILTER_TYPE, 1)
        al.alFilterf(flt, 2, 0.3)
        al.alSourcei(sources[0], al.AL_DIRECT_FILTER, flt)
        stream = al.alGenSources()
        parts = [al.alGenBuffers() for _ in range(3)]
        for b, n in zip(parts, (700, 1500, 2600)):
            al.alBufferData(b, al.AL_FORMAT_MONO_FLOAT32, _tone(n, 440.0),
                            RATE)
        al.alSourceQueueBuffers(stream, parts)
        sources.append(stream)
    for sid in sources:
        al.alSourcePlay(sid)
    return dev, ctx, sources, loop_buf


def _change(scenario: str | None, k: int, sources: list, loop_buf) -> None:
    if scenario == "moves" and k == 2:
        # New targets (ramps pending) and a pause...
        al.alSource3f(sources[1], al.AL_POSITION, 1.0, 0.0, -2.0)
        al.alSourcePause(sources[2])
    if scenario == "moves" and k == 4:
        al.alSourcePlay(sources[2])           # ...and its resume.
    if scenario == "turned_stream" and k == 2:
        # A static looping voice turned stream, with no other change:
        # its next buffer boundary is an event.
        al.alSourceQueueBuffers(sources[0], [loop_buf])


def _drive(mirror, monkeypatch, loops, once_frames, scenario, calls):
    """Render ``calls`` one-block dispatches with ``mirror`` as
    finish_chunk; returns what the app sees after each."""
    with monkeypatch.context() as mp:
        if mirror is not None:
            mp.setattr(Context, "finish_chunk", mirror)
        dev, ctx, sources, loop_buf = _api_scene(loops, once_frames,
                                                 scenario)
        seen = []
        for k in range(calls):
            _change(scenario, k, sources, loop_buf)
            out = al.alcRenderSamplesSOFT(dev, BLOCK)
            seen.append({
                "sources": sources,
                "out": out.tobytes(),
                "events": list(ctx.events),
                "state": [al.alGetSourcei(s, al.AL_SOURCE_STATE)
                          for s in sources],
                "offset": [al.alGetSourcei(s, al.AL_SAMPLE_OFFSET)
                           for s in sources],
                "table": {f: getattr(dev.table, f).tobytes()
                          for f in ParamTable._FIELDS},
                "counts": (ctx.mirror_voices_batched,
                           ctx.mirror_voices_stepped),
            })
        al.alcCloseDevice(dev)
        return seen


def _assert_seen_same(seen, ref) -> None:
    assert len(seen) == len(ref)
    for mine, theirs in zip(seen, ref):
        for key in ("out", "events", "state", "offset", "table"):
            assert mine[key] == theirs[key], key


def test_engagement_static_loops(monkeypatch):
    """64 static looping voices over 4 dispatches: every advance batched."""
    seen = _drive(None, monkeypatch, 64, None, None, calls=4)
    assert [s["counts"] for s in seen] == [(64 * k, 0) for k in (1, 2, 3, 4)]


def test_engagement_one_voice_ends(monkeypatch):
    """A non-looping voice that ends inside the second dispatch takes the
    per-voice path there, alone; events, AL_SOURCE_STATE and
    AL_SAMPLE_OFFSET match the per-voice advance after every dispatch."""
    seen = _drive(None, monkeypatch, 64, 1500, None, calls=4)
    ref = _drive(per_voice_finish_chunk, monkeypatch, 64, 1500, None,
                 calls=4)
    assert [s["counts"] for s in seen] == [(65, 0), (129, 1), (193, 1),
                                           (257, 1)]
    once = 64
    assert seen[0]["state"][once] == al.AL_PLAYING
    assert seen[1]["state"][once] == al.AL_STOPPED
    assert seen[1]["events"][len(seen[0]["events"]):] == \
        [("source_state", seen[1]["sources"][once], "stop")]
    _assert_seen_same(seen, ref)


@pytest.mark.parametrize("scenario", ["moves", "turned_stream"])
def test_api_scene_matches_per_voice_advance(monkeypatch, scenario):
    """Filters, moves, a pause and resume and a stream completing buffers;
    or a static looping voice turned stream: the same output, events,
    states, offsets and table as the per-voice advance."""
    once = 3000 if scenario == "moves" else None   # its end dirties all
    seen = _drive(None, monkeypatch, 12, once, scenario, calls=8)
    ref = _drive(per_voice_finish_chunk, monkeypatch, 12, once, scenario,
                 calls=8)
    _assert_seen_same(seen, ref)
    batched, stepped = seen[-1]["counts"]
    assert batched > 0 and stepped > 0
    if scenario == "turned_stream":
        assert any(e[0] == "buffer_completed" for e in seen[-1]["events"])
