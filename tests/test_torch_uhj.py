"""UHJ and Super Stereo voices, UHJ/TSME output and the span resampler plan
through the port, against the JAX package on the CPU (the span and
per-voice kernels' wrappers: tests/test_torch_resample.py).

Tolerances:

* ``ops/uhj.py``'s FIR tiers (every decoder, TSME's reversed j sign
  included, and both encoders at 256 and 512 taps) against the JAX
  package's, state carried over three 128-sample calls: <= 2e-6 max abs
  at unit-scale signals (FFT rounding, pocketfft against XLA's FFT).
* The IIR tier: its all-pass cascades run sample by sample here (the
  biquad kernel's plain version, which rounds as the reference's all-pass
  does) and chunk-parallel with FMA contraction in the JAX package; the
  last sections' poles sit at |z| ~ 0.9975-0.9991, which amplifies each
  ulp.  The port lies <= 2e-6 from float64 over 1024 samples
  (``python -m tests.test_torch_uhj`` prints both packages' gaps).  The
  JAX package's IIR graphs compile for 12-20 s each on XLA:CPU at 128
  samples and minutes at 1024, and its eager form exhausts XLA:CPU's code
  memory, so the IIR tier is held against the JAX package through the
  scene below (UHJ2, UHJ4 and Super Stereo decoders, the UHJ encoder) and
  against the C++ goldens in tests/test_torch_goldens.py (``uhj_out``,
  ``tsme_out``, ``src_uhj2``, ``src_uhj4``, ``ss_tsme_dec_iir``).
* The scene (pitched mono, UHJ2, UHJ4 and Super Stereo voices on UHJ
  stereo output), the port against the JAX package's 128-frame calls
  (XLA:CPU compiles its 1024-frame UHJ graphs slowly): <= 1e-5, as the
  goldens; then a JAX snapshot continues in the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from openal_soft_tpu.ops import uhj as j_uhj
from openal_soft_tpu_torch.alc.device import LoopbackDevice as TorchLoopback
from openal_soft_tpu_torch.ops import uhj as t_uhj
from openal_soft_tpu_torch.ops.kernels import biquad as t_biq
from openal_soft_tpu_torch.ops.kernels import resample_span as t_span
# The JAX device renders from private copies of its host table (ROADMAP
# C10: its render could read the table while finish_chunk advanced it).
from tests.test_torch_api import jax_renders_from_private_copies  # noqa: F401
from tests.test_torch_goldens import _conf

OPS_TOL = 2e-6
SCENE_TOL = 1e-5
T = 128
RATE = 48000
# kind: (decoded channels, buffer channels)
KINDS = {"u2": (3, 2), "u3": (3, 3), "u4": (4, 4), "ss": (3, 2),
         "ss_tsme": (3, 2)}


def _sig(rng, *shape):
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def _decode(mod, kind, tier, chans, st, width):
    """One FIR decode call of ``mod`` (j_uhj or t_uhj); st is the carried
    state dict; returns (out, st')."""
    C, n_in = KINDS[kind]
    jsgn = -1.0 if kind == "ss_tsme" else 1.0
    n = int(tier[3:])
    if kind.startswith("ss"):
        out, dh, sh = mod.super_stereo_decode(chans, st["dt_hist"],
                                              st["s_hist"], width, T, n,
                                              j_sign=jsgn)
    else:
        out, dh, sh = mod.uhj_decode(chans, st["dt_hist"], st["s_hist"], T,
                                     n_in, n)
    return out, {"dt_hist": dh, "s_hist": sh}


@pytest.mark.parametrize("tier", ["fir256", "fir512"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_decoder_matches_jax(kind, tier):
    """Every voice kind at both FIR tiers, three calls with the state
    carried; TSME's Super Stereo decoder reverses the phase shift's sign."""
    C, n_in = KINDS[kind]
    U = 3
    rng = np.random.default_rng(len(kind) + len(tier))
    width = np.array([0.46, 0.7, 0.2], np.float32)
    h = t_uhj.fir_hist(int(tier[3:]))
    st0 = {k: np.zeros((U, h), np.float32) for k in ("dt_hist", "s_hist")}
    pad = int(tier[3:]) // 2
    jst = {k: jnp.asarray(v) for k, v in st0.items()}
    tst = {k: torch.tensor(v) for k, v in st0.items()}
    outs = []
    for _ in range(3):
        chans = _sig(rng, U, C, T + pad)
        if n_in == 2:
            chans[:, 2] = 0.0
        jo, jst = _decode(j_uhj, kind, tier, jnp.asarray(chans), jst,
                          jnp.asarray(width))
        to, tst = _decode(t_uhj, kind, tier, torch.tensor(chans), tst,
                          torch.tensor(width))
        assert to.shape == (U, C, T)
        outs.append(np.abs(np.asarray(jo)).max())
        assert np.abs(to.numpy() - np.asarray(jo)).max() <= OPS_TOL
        for k in jst:
            assert np.abs(tst[k].numpy() - np.asarray(jst[k])).max() \
                <= OPS_TOL, k
    assert min(outs) > 1e-2


@pytest.mark.parametrize("tier", ["fir256", "fir512"])
@pytest.mark.parametrize("enc", ["uhj", "tsme"])
def test_encoder_matches_jax(enc, tier):
    """The UHJ (W, X, Y) and TSME (W, Y, Z, X) FIR stereo encoders, three
    calls with the state carried."""
    rng = np.random.default_rng(7 + len(tier))
    n_in = 3 if enc == "uhj" else 4
    cls = "UhjEncoderState" if enc == "uhj" else "TsmeEncoderState"
    je = getattr(j_uhj, cls)(int(tier[3:]))
    te = getattr(t_uhj, cls)(int(tier[3:]))
    jst, tst = je.init(), te.init("cpu")
    for _ in range(3):
        ins = [_sig(rng, T) for _ in range(n_in)]
        jst, jl, jr = je.encode(jst, *map(jnp.asarray, ins), T)
        tst, tl, tr = te.encode(tst, *map(torch.tensor, ins), T)
        for a, b in ((tl, jl), (tr, jr)):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= OPS_TOL
        for k in jst:
            assert np.abs(tst[k].numpy() - np.asarray(jst[k])).max() \
                <= OPS_TOL, k


def test_iir_decode_runs_two_biquad_launches_per_cascade(monkeypatch):
    """A UHJ4 decode's five all-pass streams run as two cascades (the +90
    filters on D/T and S, the direct filters on S, D/T and Q), each as one
    four-section biquad call over all rows: two calls, whatever the voice
    count."""
    calls = []
    real = t_biq.biquad_dual

    def counting(x, *args):
        calls.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(t_uhj.biq, "biquad_dual", counting)
    st = {k: torch.zeros(5, 4, 2) for k in ("f2dt", "f1s", "f1dt", "f2s",
                                            "f1q")}
    t_uhj.uhj_decode_iir(torch.zeros(5, 4, T + 1), st, T, 4)
    assert calls == [(10, T), (15, T)]


def _allpass_f64(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """The four-section all-pass cascade in float64, sample by sample."""
    y = x.astype(np.float64)
    for a in coeffs.astype(np.float64):
        z0 = np.zeros(y.shape[0])
        z1 = np.zeros(y.shape[0])
        out = np.empty_like(y)
        for t in range(y.shape[1]):
            yt = a * y[:, t] + z0
            z0, z1 = z1, a * yt - y[:, t]
            out[:, t] = yt
        y = out
    return y


def allpass_gaps(n: int = 1024) -> dict:
    """Max |port - float64| of each IIR cascade over n samples of unit-scale
    noise (the JAX package's chunked form compiles slowly on XLA:CPU at
    this length; ``python -m tests.test_torch_uhj`` adds it)."""
    x = (np.random.default_rng(0).standard_normal((4, n)) * 0.5
         ).astype(np.float32)
    gaps = {}
    for name, c in (("filter1", t_uhj.FILTER1_COEFF),
                    ("filter2", t_uhj.FILTER2_COEFF)):
        (y,), _ = t_uhj._allpass4([torch.tensor(x)],
                                  [torch.zeros(4, 4, 2)], c)
        gaps[name] = float(np.abs(y.numpy() - _allpass_f64(x, c)).max())
    return gaps


def test_allpass_cascades_near_float64():
    assert max(allpass_gaps().values()) <= 2e-6


# --- the scene ---------------------------------------------------------------


def _scene(cls, **dev_kw):
    """Pitched mono, UHJ2, UHJ4 and Super Stereo (width 0.46) voices, all
    looping, on a stereo device (UHJ output under the module's conf)."""
    dev = cls(frequency=RATE, channels="stereo", sample_type="float32",
              capacity=16, **dev_kw)
    ctx = dev.create_context()
    t = np.arange(RATE // 2) / RATE

    def tone(f, g=0.2):
        return (g * np.sin(2 * np.pi * f * t)).astype(np.float32)

    voices = (("mono", tone(220.0), {"pitch": 1.3,
                                     "position": (1.0, 0.0, -2.0)}),
              ("uhj2", np.stack([tone(330.0), tone(550.0, 0.15)], 1),
               {"position": (0.4, 0.1, -1.0)}),
              ("uhj4", np.stack([tone(300.0), tone(500.0, 0.1),
                                 tone(700.0, 0.05), tone(900.0, 0.05)], 1),
               {"pitch": 0.8}),
              ("superstereo", np.stack([tone(250.0), tone(450.0, 0.12)], 1),
               {}))
    for fmt, data, props in voices:
        buf = ctx.create_buffer()
        buf.set_data(data, fmt, "float32", RATE)
        src = ctx.create_source()
        src.buffer(buf)
        src.looping = True
        for k, v in props.items():
            src.set(k, v)
        src.play()
    return dev


@pytest.fixture(scope="module")
def uhj_scene():
    """(port device, [(segment, JAX out, port out)]): 1024 frames in
    128-frame calls on both, then 8192 frames (the port's multi-block
    branch with the decoders' look-ahead) and odd sizes; then the JAX
    snapshot replaces the port's state and both go on for 1024 frames."""
    from openal_soft_tpu.alc import config as j_conf
    from openal_soft_tpu.alc.device import LoopbackDevice as JaxLoopback

    try:
        with _conf("stereo-encoding = uhj\n"):
            j_conf.load_config(reload=True)
            j = _scene(JaxLoopback)
            p = _scene(TorchLoopback, device="cpu")
    finally:
        j_conf.load_config(reload=True)

    def small(dev, n):
        return np.concatenate([dev.render_samples(T) for _ in range(n // T)])

    out = [("warm", small(j, 1024), small(p, 1024))]
    for n in (8192, 100, 924):
        out.append((str(n), np.concatenate([j.render_samples(min(T, n - i))
                                            for i in range(0, n, T)]),
                    p.render_samples(n)))
    j.render_samples(28)              # back on the 128-frame grid
    p.render_samples(28)
    snap = j.snapshot()
    for k in [k for k in p._state if k.startswith(("uhj_", "enc_"))]:
        p._state[k].fill_(1.0)         # the continuation must come from snap
    p.restore(snap)
    out.append(("restored", small(j, 1024), p.render_samples(1024)))
    return p, out, snap


@pytest.mark.parametrize("seg", range(6), ids=["warm", "8192", "100", "924",
                                                "restored", "state"])
def test_uhj_scene_matches_jax(uhj_scene, seg):
    p, out, snap = uhj_scene
    if seg == 5:
        # The snapshot carries every decoder's and the encoder's state
        # under the JAX package's names.
        names = {k for k in snap["state"] if k.startswith(("uhj_", "enc_"))}
        assert {"uhj_u2_f1s", "uhj_u4_f1q", "uhj_ss_f2dt", "uhj_split",
                "enc_f1wx", "enc_dy"} <= names
        assert names <= set(p.snapshot()["state"])
        return
    name, want, got = out[seg]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 1e-2
    err = float(np.abs(got - want).max())
    assert err <= SCENE_TOL, f"{name}: max |diff| {err:.3e}"


def test_uhj_scene_takes_the_padded_paths(uhj_scene):
    p, _, _ = uhj_scene
    assert p.layout.uhj_output and p._uhj_pad() == 128
    assert {k: len(v) for k, v in p._uhj_groups.items()} == {
        "u2": 1, "u3": 0, "u4": 1, "ss": 1}
    assert not p._fused(p._graph_gates())
    assert p._rs_plan(1024, 8) == ("gen", 8)


# --- the span plan and the K4/K5 wrappers on the CPU ------------------------


def _pitched_scene(n_voices: int, n_tones: int, looping: bool = True,
                   loop_frames: int | None = None):
    dev = TorchLoopback(frequency=RATE, channels="stereo",
                        sample_type="float32", capacity=n_voices,
                        device="cpu")
    ctx = dev.create_context()
    rng = np.random.default_rng(3)
    bufs = []
    for i in range(n_tones):
        buf = ctx.create_buffer()
        buf.set_data(_sig(rng, RATE), "mono", "float32", RATE)
        if loop_frames is not None:
            buf.loop_end = loop_frames
        bufs.append(buf)
    for i in range(n_voices):
        src = ctx.create_source()
        src.buffer(bufs[i % n_tones])
        src.looping = looping
        src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
        src.set("position", tuple(rng.standard_normal(3)))
        src.play()
    return dev


def test_span_plan_follows_the_pool():
    """Pitched voices go to the span kernel when their buffers outgrow L2
    (lowered here to 100 KB) and every loop covers a tile's window, to the
    general kernel otherwise; native-rate voices keep the unit kernel."""
    p = _pitched_scene(8, 4)
    ref = _pitched_scene(8, 4)
    p.render_samples(1024)
    ref.render_samples(1024)
    assert p._pool_extent_bytes >= 4 * RATE * 4
    assert p._rs_plan(1024, 16) == ("gen", 16)
    p.l2_bytes = 100_000
    ref.l2_bytes = 100_000
    assert p._rs_plan(1024, 16) == ("span", 16)
    assert p._rs_plan(1024, 8) == ("span", 8)
    assert p._rs_plan(1024, 3) == ("span", 1)
    before = t_span.resample_span.launches
    ref.l2_bytes = 1 << 40
    a, b = p.render_samples(8192), ref.render_samples(8192)
    assert t_span.resample_span.launches == before   # plain on the CPU
    np.testing.assert_array_equal(a, b)              # the same plain version
    short = _pitched_scene(4, 2, loop_frames=300)
    short.render_samples(128)
    short.l2_bytes = 1000
    assert short._pool_extent_bytes > 1000
    assert short._rs_plan(1024, 16) == ("gen", 16)   # loops < the window
    for s in short.contexts[0].sources.values():
        s.set("pitch", 1.0)
    short.render_samples(128)
    assert short._rs_plan(1024, 16) == ("unit", 16)


if __name__ == "__main__":
    import jax

    from openal_soft_tpu.ops import filters as j_f

    print("port - float64:", allpass_gaps())
    x = (np.random.default_rng(0).standard_normal((4, 1024)) * 0.5
         ).astype(np.float32)
    for name, c in (("filter1", j_uhj.FILTER1_COEFF),
                    ("filter2", j_uhj.FILTER2_COEFF)):
        y, z = jnp.asarray(x), jnp.zeros((4, 2))
        for a in c:                   # eager: jit compiles for minutes here
            cf = jnp.broadcast_to(jnp.asarray(
                [a, 0.0, -1.0, 0.0, -a], jnp.float32), (1024 // 32, 4, 5))
            y, _ = j_f._biquad_chunked_single(y, z, cf, 32)
        print(f"JAX {name} - float64:",
              float(np.abs(np.asarray(y) - _allpass_f64(x, c)).max()))
    del jax
