"""The port's EAX 2.0-5.0 layer (openal_soft_tpu_torch.al.eax) against the
JAX package's, call for call, on the CPU.

The EAX mapping is host code in both packages: the values it writes into
effects, slots and sources are compared within 1e-6, raw (byte-level)
property reads exactly.  An EAX scene with occlusion (filters and the
reverb slot) renders within 1e-4 of the JAX package's, which renders in
128-frame calls.  The scene is ``tests/test_eax.py``'s (44.1 kHz,
capacity 16).
"""

import struct

import numpy as np
import pytest

from openal_soft_tpu.al import api as jax_api
from openal_soft_tpu.al import eax as jax_eax
from openal_soft_tpu_torch.al import api as port_api
from openal_soft_tpu_torch.al import eax
from tests.test_torch_api import jax_renders_from_private_copies  # noqa: F401

RATE = 44100
TOL = 1e-6          # floats derived from the EAX mapping
RENDER_TOL = 1e-4   # renders with the reverb and filters
PACKAGES = {"jax": (jax_api, jax_eax, {}),
            "port": (port_api, eax, {"device": "cpu"})}
L20 = eax.DSPROPSETID_EAX20_ListenerProperties
B20 = eax.DSPROPSETID_EAX20_BufferProperties


def _scene(api, dev_kw):
    """tests/test_eax.py's scene: one looping float32 tone."""
    dev = api.alcLoopbackOpenDeviceSOFT(frequency=RATE, capacity=16,
                                        **dev_kw)
    ctx = api.alcCreateContext(dev)
    api.alcMakeContextCurrent(ctx)
    bid = api.alGenBuffers(1)
    t = np.arange(RATE // 4) / RATE
    api.alBufferData(bid, 0x10010,
                     (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32),
                     RATE)
    sid = api.alGenSources(1)
    api.alSourcei(sid, 0x1009, bid)          # AL_BUFFER
    api.alSourcei(sid, 0x1007, 1)            # AL_LOOPING
    return dev, ctx, sid


def _values(x):
    """Numbers and containers as plain Python, for comparison."""
    if isinstance(x, dict):
        return {k: _values(v) for k, v in x.items() if k != "buffer"}
    if isinstance(x, (list, tuple)):
        return [_values(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    return x


def _close(got, want, path="") -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _eax_state(mod, ctx, sid):
    st = mod.get_eax(ctx)
    src = ctx.sources[sid]
    slots = [None if s is None else
             {"effect": s._eax_effect.type,
              "props": s._eax_effect.props, "gain": s.gain,
              "slot_props": s.effect_props,
              "decay_time": s.decay_time} for s in st.slots]
    sends = [{"slot": None if sp.slot is None else sp.slot.id,
              "gain": sp.gain, "gain_hf": sp.gain_hf, "gain_lf": sp.gain_lf}
             for sp in src.props.send]
    return _values({
        "slots": slots, "types": st.slot_effect_type,
        "primary": st.primary_fx_slot, "env": st.listener_env,
        "size": st.listener_size, "flags": st.listener_flags,
        "direct": [src.props.direct_gain, src.props.direct_gain_hf,
                   src.props.direct_gain_lf],
        "sends": sends})


@pytest.mark.parametrize("env", range(26))
def test_eax2_environment_matches_jax(env):
    """Each EAX 2.0 environment: the slot-0 reverb, the listener getters
    and a size change scaled by the environment's flags."""
    out = {}
    for name, (api, mod, kw) in PACKAGES.items():
        dev, ctx, sid = _scene(api, kw)
        api.EAXSet(L20, eax.L20_ENVIRONMENT, 0, env)
        got = [_eax_state(mod, ctx, sid)]
        got.append(_values([api.EAXGet(L20, pid, 0) for pid in (
            eax.L20_ROOM, eax.L20_ROOMHF, eax.L20_ROOMROLLOFF,
            eax.L20_DECAYTIME, eax.L20_DECAYHFRATIO, eax.L20_REFLECTIONS,
            eax.L20_REFLECTIONSDELAY, eax.L20_REVERB, eax.L20_REVERBDELAY,
            eax.L20_ENVIRONMENT, eax.L20_ENVIRONMENTSIZE,
            eax.L20_ENVIRONMENTDIFFUSION, eax.L20_AIRABSORPTIONHF,
            eax.L20_FLAGS)]))
        api.EAXSet(L20, eax.L20_ENVIRONMENTSIZE, 0,
                   1.7 * api.EAXGet(L20, eax.L20_ENVIRONMENTSIZE, 0))
        got.append(_eax_state(mod, ctx, sid))
        got.append(api.alGetError())
        out[name] = got
    _close(out["port"], out["jax"])


def _source_calls(api, mod, kw):
    dev, ctx, sid = _scene(api, kw)
    seen = []
    for pid, value in ((eax.B20_OCCLUSION, -1200), (eax.B20_DIRECT, -300),
                       (eax.B20_DIRECTHF, -150), (eax.B20_ROOM, -500),
                       (eax.B20_OBSTRUCTION, -800),
                       (eax.B20_OBSTRUCTIONLFRATIO, 0.3),
                       (eax.B20_OCCLUSIONLFRATIO, 0.5),
                       (eax.B20_OCCLUSIONROOMRATIO, 2.0),
                       (eax.B20_ROOMHF, -900)):
        api.EAXSet(B20, pid, sid, value)
        seen.append(_eax_state(mod, ctx, sid))
        seen.append(_values(api.EAXGet(B20, pid, sid)))
    api.EAXSet(B20, eax.B20_ALL, sid, {"occlusion": -2000, "direct": 0})
    seen.append(_eax_state(mod, ctx, sid))
    seen.append(api.alGetError())
    return seen


def test_eax2_source_properties_match_jax():
    """Obstruction, occlusion and room settings rewrite the source's
    direct and send-0 filter gains identically."""
    _close(_source_calls(*PACKAGES["port"]), _source_calls(*PACKAGES["jax"]))


def _slot_and_raw_calls(api, mod, kw):
    dev, ctx, sid = _scene(api, kw)
    S0 = mod.EAXPROPERTYID_EAX50_FXSlot0
    S = mod.EAXPROPERTYID_EAX50_Source
    C = mod.EAXPROPERTYID_EAX50_Context
    seen = []
    api.EAXSet(mod.EAXPROPERTYID_EAX40_FXSlot1, mod.FXSLOT_LOADEFFECT, 0,
               mod.EAX_CHORUS_EFFECT)
    api.EAXSet(mod.EAXPROPERTYID_EAX40_Context, 2, 0,
               mod.EAXPROPERTYID_EAX40_FXSlot1)
    seen.append(_eax_state(mod, ctx, sid))
    api.EAXSet(mod.EAXPROPERTYID_EAX40_Context, 2, 0,
               mod.EAXPROPERTYID_EAX40_FXSlot0)
    api.EAXSet(S0, mod.RV_ENVIRONMENT, 0, 10)
    api.EAXSet(S0, mod.RV_ENVIRONMENTSIZE, 0,
               2.0 * api.EAXGet(S0, mod.RV_ENVIRONMENTSIZE, 0))
    api.EAXSet(S0, mod.FXSLOT_VOLUME, 0, -600)
    api.EAXSet(C, mod.CTX_SPEAKERCONFIG, 0, 1)
    api.EAXSet(C, mod.CTX_MACROFXFACTOR, 0, 0.5)
    seen.append(_values([api.EAXGet(S0, mod.RV_DECAYTIME, 0),
                         api.EAXGet(S0, mod.RV_ENVIRONMENT, 0),
                         api.EAXGet(C, mod.CTX_MACROFXFACTOR, 0)]))
    seen.append(_eax_state(mod, ctx, sid))
    raw = mod.eax_get_raw(ctx, S0, mod.RV_ALL, 0, 112)
    seen.append(raw)
    seen.append(mod.eax_set_raw(ctx, S0, mod.RV_ALL, 0, raw))
    seen.append(mod.eax_set_raw(ctx, S0, mod.RV_DECAYTIME, 0,
                                struct.pack("<f", 4.25)))
    for pid, payload in ((mod.SRC_DIRECT, struct.pack("<l", -300)),
                         (mod.SRC_OCCLUSIONPARAMS,
                          struct.pack("<lfff", -1200, 0.3, 1.2, 0.8)),
                         (mod.SRC_EXCLUSIONPARAMS,
                          struct.pack("<lf", -900, 1.0)),
                         (mod.SRC_SPEAKERLEVELS,
                          b"".join(struct.pack("<ll", i + 1, -100 * (i + 1))
                                   for i in range(9))),
                         (mod.SRC_MACROFXFACTOR, struct.pack("<f", 0.25))):
        seen.append(mod.eax_set_raw(ctx, S, pid, sid, payload))
        seen.append(_eax_state(mod, ctx, sid))
    seen.append(mod.eax_get_raw(ctx, S, mod.SRC_ALL, sid, 80))
    seen.append(mod.eax_get_raw(ctx, S, mod.SRC_SPEAKERLEVELS, sid, 72))
    seen.append(mod.eax_get_raw(ctx, C, mod.CTX_SPEAKERCONFIG, 0, 4))
    seen.append(api.EAXSetRaw(C, mod.CTX_MACROFXFACTOR, 0,
                              struct.pack("<f", 0.75)))
    seen.append(api.EAXGetRaw(C, mod.CTX_MACROFXFACTOR, 0, 4))
    seen.append(api.alGetError())
    return seen


def test_eax4_and_eax5_slots_and_raw_abi_match_jax():
    """EAX 4/5 fx slots, the context and source property sets, and the
    raw ABI the C shim uses: equal states and byte-equal raw reads."""
    _close(_slot_and_raw_calls(*PACKAGES["port"]),
           _slot_and_raw_calls(*PACKAGES["jax"]))


def test_eax_occlusion_scene_renders_as_jax():
    """Hangar, room -600 mB, occlusion -1200 mB on the playing source:
    within 1e-4 of the JAX package, both rendering 16 calls of 128 frames
    (the reverb fades its first parameters over one update, so the call
    sizes must match)."""
    out = {}
    for name, (api, mod, kw) in PACKAGES.items():
        dev, ctx, sid = _scene(api, kw)
        api.EAXSet(L20, eax.L20_ENVIRONMENT, 0, 10)
        api.EAXSet(L20, eax.L20_ROOM, 0, -600)
        api.EAXSet(B20, eax.B20_OCCLUSION, sid, -1200)
        api.alSourcePlay(sid)
        out[name] = np.concatenate([dev.render_samples(128)
                                    for _ in range(16)])
        if name == "port":
            assert "gate:nofilt" not in dev._graph_gates()
            assert "gate:nosendfilt" not in dev._graph_gates()
    err = float(np.abs(out["port"] - out["jax"]).max())
    assert err <= RENDER_TOL, err
    assert np.abs(out["port"]).max() > 0.01


def test_eax_occlusion_reaches_the_next_dispatch():
    """An occlusion set on a playing source changes the very next render:
    the EAX gains reach the direct and send filters as a direct filter
    set through the AL does."""
    outs = []
    for occlude in (False, True):
        dev, ctx, sid = _scene(port_api, {"device": "cpu"})
        port_api.EAXSet(L20, eax.L20_ENVIRONMENT, 0, 10)
        port_api.alSourcePlay(sid)
        first = dev.render_samples(1024)
        if occlude:
            port_api.EAXSet(B20, eax.B20_OCCLUSION, sid, -1200)
        outs.append((first, dev.render_samples(1024)))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert float(np.abs(outs[0][1] - outs[1][1]).max()) > 1e-3
    assert np.isfinite(outs[1][1]).all()
