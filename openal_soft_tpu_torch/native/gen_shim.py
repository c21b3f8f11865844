#!/usr/bin/env python3
"""Emit shim_generated.cpp: the mechanical part of the libopenal_torch C ABI.

The reference's export table (alc/export_list.h) is ~777 entries, most of
them the f/3f/fv/i/3i/iv get/set matrix over sources/listener/buffers plus
a *Direct variant of every AL entry point (al/direct_defs.h expands them
from macro tables).  This generator is our macro table: each spec line
describes one AL function (name, C signature, marshalling kind); the
emitter writes the C entry point and, for every al* function, the
*Direct variant that routes through api.alDirectCall(name, context, ...)
instead of the thread-local current context.

Run: python3 gen_shim.py > shim_generated.cpp   (build.py does this, into
the package's _build/ directory: no generated source is checked in).
"""

from __future__ import annotations

# C type spellings per short code.
CTYPE = {
    "I": "ALuint", "i": "ALint", "f": "ALfloat", "d": "ALdouble",
    "e": "ALenum", "z": "ALsizei", "b": "ALboolean", "q": "ALint64SOFT",
    "Q": "ALuint64SOFT",
}
# Py_BuildValue codes per short code.
BVC = {"I": "I", "i": "i", "f": "f", "d": "d", "e": "i", "z": "i",
       "b": "i", "q": "L", "Q": "K"}

HEADER = r"""/* Generated by gen_shim.py — DO NOT EDIT BY HAND.
 *
 * The mechanical half of libopenal_torch.so's export surface: the full AL
 * get/set matrix, object lifecycles, EFX parameter entry points, global
 * state queries, and a *Direct variant of every AL function
 * (al/direct_defs.h analog).  Hand-marshalled entries (device lifecycle,
 * render, capture, buffer data, EAX, callbacks) live in alc_shim.cpp.
 */

#include "shim_runtime.h"

#include <cstring>

using ALCcontext = void;
using ALCdevice = void;
using ALenum = int;
using ALuint = unsigned int;
using ALint = int;
using ALsizei = int;
using ALfloat = float;
using ALdouble = double;
using ALboolean = char;
using ALchar = char;
using ALint64SOFT = long long;
using ALuint64SOFT = unsigned long long;

using shim::Gil;
using shim::call;
using shim::call_long;
using shim::call_double;
using shim::call_void;
using shim::call_string;
using shim::vec_len;

namespace {

/* Copy a Python number sequence (or scalar) into an out array. */
template<typename T>
void seq_out(PyObject *r, T *out, int max_n)
{
    if(!r) return;
    if(PyFloat_Check(r) || PyLong_Check(r) || PyBool_Check(r)) {
        if(max_n >= 1)
            out[0] = PyFloat_Check(r) ? static_cast<T>(PyFloat_AsDouble(r))
                                      : static_cast<T>(PyLong_AsLongLong(r));
        return;
    }
    PyObject *fast = PySequence_Fast(r, "");
    if(!fast) { PyErr_Clear(); return; }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    for(Py_ssize_t k = 0; k < n && k < max_n; ++k) {
        PyObject *it = PySequence_Fast_GET_ITEM(fast, k);
        out[k] = PyFloat_Check(it) ? static_cast<T>(PyFloat_AsDouble(it))
                                   : static_cast<T>(PyLong_AsLongLong(it));
    }
    Py_DECREF(fast);
}

template<typename T>
PyObject *seq_in(const T *vals, int n, bool is_float)
{
    PyObject *lst = PyList_New(n);
    for(int k = 0; k < n; ++k)
        PyList_SET_ITEM(lst, k,
            is_float ? PyFloat_FromDouble(static_cast<double>(vals[k]))
                     : PyLong_FromLongLong(static_cast<long long>(vals[k])));
    return lst;
}

} // namespace

extern "C" {
"""

FOOTER = "\n} /* extern \"C\" */\n"


def sig(args):
    """[(code, name)] -> C parameter list string."""
    return ", ".join(f"{CTYPE[c]} {n}" for c, n in args)


def bv(args):
    """Py_BuildValue("(codes)", names...) from [(code, name)]."""
    codes = "".join(BVC[c] for c, _ in args)
    names = ", ".join(n for _, n in args)
    casts = {"I": "unsigned int", "q": "long long", "Q": "unsigned long long"}
    parts = []
    for c, n in args:
        if c in ("f", "d"):     # "d" passes a C double (ALdouble or float)
            parts.append(f"static_cast<double>({n})")
        elif c in casts:
            parts.append(f"static_cast<{casts[c]}>({n})")
        else:
            parts.append(f"static_cast<int>({n})")
    joined = ", ".join(parts)
    return codes, joined


class Fn:
    """One generated entry point."""

    def __init__(self, name, kind, args=(), py=None, ret="void",
                 vlen=None, elem="f", direct=True):
        self.name = name
        self.kind = kind        # emit strategy
        self.args = list(args)  # [(code, argname)]
        self.py = py or name    # python api function
        self.ret = ret
        self.vlen = vlen        # fixed vector length (None -> vec_len(param))
        self.elem = elem        # vector element code ("f"/"i"/"d"/"q")
        self.direct = direct


def direct_name(name: str) -> str:
    """AL_EXT_direct_context naming: "Direct" goes BEFORE the extension
    suffix (alSourcedSOFT -> alSourcedDirectSOFT, alPopDebugGroupEXT ->
    alPopDebugGroupDirectEXT; al/direct_defs.h DECL_FUNCEXT)."""
    for suf in ("SOFT", "EXT"):
        if name.endswith(suf):
            return name[:-len(suf)] + "Direct" + suf
    return name + "Direct"


def emit(fn: Fn, direct: bool) -> str:
    name = direct_name(fn.name) if direct else fn.name
    cargs = ([("P", "context")] if direct else []) + fn.args
    proto_args = ", ".join(
        (["ALCcontext *context"] if direct else [])
        + [f"{CTYPE[c]} {n}" for c, n in fn.args])

    def build(extra_fmt="", extra_vals="", tail_fmt="", tail_vals=""):
        """BuildValue for fn.args (+optional leading/trailing pieces)."""
        codes, vals = bv(fn.args)
        fmt = extra_fmt + codes + tail_fmt
        allvals = ", ".join(x for x in (extra_vals, vals, tail_vals) if x)
        if direct:
            fmt = "sO" + fmt
            allvals = ", ".join(x for x in (
                f'"{fn.py}"', "static_cast<PyObject*>(context)", allvals)
                if x)
            pyname = "alDirectCall"
        else:
            pyname = fn.py
        return pyname, fmt, allvals

    k = fn.kind
    body = ""
    ret = fn.ret
    if k == "void":
        pyname, fmt, vals = build()
        body = f'    Gil gil; call_void("{pyname}", ' \
               f'Py_BuildValue("({fmt})"{", " + vals if vals else ""}));'
        return f"void {name}({proto_args})\n{{\n{body}\n}}\n"

    if k == "ret_long":
        pyname, fmt, vals = build()
        return (f"{ret} {name}({proto_args})\n{{\n"
                f"    Gil gil;\n"
                f"    return static_cast<{ret}>(call_long(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\"{', ' + vals if vals else ''})));\n"
                f"}}\n")

    if k == "ret_double":
        pyname, fmt, vals = build()
        return (f"{ret} {name}({proto_args})\n{{\n"
                f"    Gil gil;\n"
                f"    return static_cast<{ret}>(call_double(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\"{', ' + vals if vals else ''})));\n"
                f"}}\n")

    if k == "ret_string":
        pyname, fmt, vals = build()
        return (f"const ALchar *{name}({proto_args})\n{{\n"
                f"    Gil gil;\n"
                f"    return call_string(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\"{', ' + vals if vals else ''}));\n"
                f"}}\n")

    if k == "get_scalar":
        # void alGetXf(args..., T *value)
        T = CTYPE[fn.elem]
        pyname, fmt, vals = build()
        conv = ("call_double" if fn.elem in ("f", "d") else "call_long")
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"{T} *value)\n{{\n"
                f"    Gil gil;\n"
                f"    *value = static_cast<{T}>({conv}(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\"{', ' + vals if vals else ''})));\n"
                f"}}\n")

    if k == "get_3":
        T = CTYPE[fn.elem]
        pyname, fmt, vals = build()
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"{T} *v1, {T} *v2, {T} *v3)\n{{\n"
                f"    Gil gil;\n"
                f"    {T} tmp[3] = {{}};\n"
                f"    PyObject *r = call(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\"{', ' + vals if vals else ''}));\n"
                f"    seq_out(r, tmp, 3);\n"
                f"    Py_XDECREF(r);\n"
                f"    *v1 = tmp[0]; *v2 = tmp[1]; *v3 = tmp[2];\n"
                f"}}\n")

    if k == "get_v":
        T = CTYPE[fn.elem]
        n = fn.vlen if fn.vlen is not None else "vec_len(param)"
        pyname, fmt, vals = build()
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"{T} *values)\n{{\n"
                f"    Gil gil;\n"
                f"    PyObject *r = call(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\"{', ' + vals if vals else ''}));\n"
                f"    seq_out(r, values, {n});\n"
                f"    Py_XDECREF(r);\n"
                f"}}\n")

    if k == "set_v":
        T = CTYPE[fn.elem]
        n = fn.vlen if fn.vlen is not None else "vec_len(param)"
        is_f = "true" if fn.elem in ("f", "d") else "false"
        pyname, fmt, vals = build(tail_fmt="N",
                                  tail_vals=f"seq_in(values, {n}, {is_f})")
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"const {T} *values)\n{{\n"
                f"    Gil gil;\n"
                f"    call_void(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\", {vals}));\n"
                f"}}\n")

    if k == "gen_obj":
        pyname, fmt, vals = build(tail_fmt="i", tail_vals="1")
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"ALsizei n, ALuint *ids)\n{{\n"
                f"    shim::ensure_init();\n"
                f"    Gil gil;\n"
                f"    for(ALsizei k = 0; k < n; ++k)\n"
                f"        ids[k] = static_cast<ALuint>(call_long(\"{pyname}\","
                f" Py_BuildValue(\"({fmt})\", {vals})));\n"
                f"}}\n")

    if k == "del_obj":
        pyname, fmt, vals = build(tail_fmt="N",
                                  tail_vals="seq_in(ids, n, false)")
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"ALsizei n, const ALuint *ids)\n{{\n"
                f"    Gil gil;\n"
                f"    call_void(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\", {vals}));\n"
                f"}}\n")

    if k == "is_obj":
        pyname, fmt, vals = build()
        return (f"ALboolean {name}({proto_args})\n{{\n"
                f"    Gil gil;\n"
                f"    return static_cast<ALboolean>(call_long(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\"{', ' + vals if vals else ''})));\n"
                f"}}\n")

    if k == "each":
        # void alSourcePlayv(n, ids): call py once per id
        pyname, fmt, vals = build(tail_fmt="I", tail_vals="ids[k]")
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"ALsizei n, const ALuint *ids)\n{{\n"
                f"    Gil gil;\n"
                f"    for(ALsizei k = 0; k < n; ++k)\n"
                f"        call_void(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\", {vals}));\n"
                f"}}\n")

    if k == "queue":
        pyname, fmt, vals = build(tail_fmt="N",
                                  tail_vals="seq_in(ids, n, false)")
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"ALsizei n, const ALuint *ids)\n{{\n"
                f"    Gil gil;\n"
                f"    call_void(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\", {vals}));\n"
                f"}}\n")

    if k == "unqueue":
        pyname, fmt, vals = build(tail_fmt="i", tail_vals="static_cast<int>(n)")
        return (f"void {name}({proto_args}{', ' if proto_args else ''}"
                f"ALsizei n, ALuint *ids)\n{{\n"
                f"    Gil gil;\n"
                f"    PyObject *r = call(\"{pyname}\", "
                f"Py_BuildValue(\"({fmt})\", {vals}));\n"
                f"    seq_out(r, ids, n);\n"
                f"    Py_XDECREF(r);\n"
                f"}}\n")

    raise ValueError(f"unknown kind {k}")


def functions():
    F = Fn
    src = [("I", "source")]
    par = [("e", "param")]
    fns = []

    # --- sources: setters --------------------------------------------------
    fns += [
        F("alSourcef", "void", src + par + [("f", "value")]),
        F("alSource3f", "void", src + par + [("f", "v1"), ("f", "v2"),
                                             ("f", "v3")]),
        F("alSourcefv", "set_v", src + par, elem="f"),
        F("alSourcei", "void", src + par + [("i", "value")]),
        F("alSource3i", "void", src + par + [("i", "v1"), ("i", "v2"),
                                             ("i", "v3")]),
        F("alSourceiv", "set_v", src + par, elem="i"),
        F("alSourcei64SOFT", "void", src + par + [("q", "value")]),
        F("alSource3i64SOFT", "void", src + par + [("q", "v1"), ("q", "v2"),
                                                   ("q", "v3")]),
        F("alSourcei64vSOFT", "set_v", src + par, elem="q"),
        F("alSourcedSOFT", "void", src + par + [("d", "value")]),
        F("alSource3dSOFT", "void", src + par + [("d", "v1"), ("d", "v2"),
                                                 ("d", "v3")]),
        F("alSourcedvSOFT", "set_v", src + par, elem="d"),
        # getters
        F("alGetSourcef", "get_scalar", src + par, elem="f"),
        F("alGetSource3f", "get_3", src + par, elem="f"),
        F("alGetSourcefv", "get_v", src + par, elem="f"),
        F("alGetSourcei", "get_scalar", src + par, elem="i"),
        F("alGetSource3i", "get_3", src + par, elem="i"),
        F("alGetSourceiv", "get_v", src + par, elem="i"),
        F("alGetSourcedSOFT", "get_scalar", src + par, elem="d"),
        F("alGetSource3dSOFT", "get_3", src + par, elem="d"),
        F("alGetSourcedvSOFT", "get_v", src + par, elem="d", vlen=2),
        F("alGetSourcei64SOFT", "get_scalar", src + par, elem="q"),
        F("alGetSource3i64SOFT", "get_3", src + par, elem="q"),
        F("alGetSourcei64vSOFT", "get_v", src + par, elem="q", vlen=2),
        # playback control
        F("alSourcePlay", "void", src),
        F("alSourceStop", "void", src),
        F("alSourcePause", "void", src),
        F("alSourceRewind", "void", src),
        F("alSourcePlayv", "each", [], py="alSourcePlay"),
        F("alSourceStopv", "each", [], py="alSourceStop"),
        F("alSourcePausev", "each", [], py="alSourcePause"),
        F("alSourceRewindv", "each", [], py="alSourceRewind"),
        F("alSourcePlayAtTimeSOFT", "void", src + [("q", "start_time")]),
        # queue
        F("alSourceQueueBuffers", "queue", src),
        F("alSourceUnqueueBuffers", "unqueue", src),
        # lifecycle
        F("alGenSources", "gen_obj", []),
        F("alDeleteSources", "del_obj", []),
        F("alIsSource", "is_obj", [("I", "source")]),
    ]

    # --- listener ------------------------------------------------------------
    fns += [
        F("alListenerf", "void", par + [("f", "value")]),
        F("alListener3f", "void", par + [("f", "v1"), ("f", "v2"),
                                         ("f", "v3")]),
        F("alListenerfv", "set_v", par, elem="f"),
        F("alListeneri", "void", par + [("i", "value")]),
        F("alListener3i", "void", par + [("i", "v1"), ("i", "v2"),
                                         ("i", "v3")]),
        F("alListeneriv", "set_v", par, elem="i"),
        F("alGetListenerf", "get_scalar", par, elem="f"),
        F("alGetListener3f", "get_3", par, elem="f"),
        F("alGetListenerfv", "get_v", par, elem="f"),
        F("alGetListeneri", "get_scalar", par, elem="i"),
        F("alGetListener3i", "get_3", par, elem="i"),
        F("alGetListeneriv", "get_v", par, elem="i"),
    ]

    # --- buffers ---------------------------------------------------------------
    buf = [("I", "buffer")]
    fns += [
        F("alBufferf", "void", buf + par + [("f", "value")]),
        F("alBuffer3f", "void", buf + par + [("f", "v1"), ("f", "v2"),
                                             ("f", "v3")]),
        F("alBufferfv", "set_v", buf + par, elem="f"),
        F("alBufferi", "void", buf + par + [("i", "value")]),
        F("alBuffer3i", "void", buf + par + [("i", "v1"), ("i", "v2"),
                                             ("i", "v3")]),
        F("alBufferiv", "set_v", buf + par, elem="i"),
        F("alGetBufferf", "get_scalar", buf + par, elem="f"),
        F("alGetBuffer3f", "get_3", buf + par, elem="f"),
        F("alGetBufferfv", "get_v", buf + par, elem="f"),
        F("alGetBufferi", "get_scalar", buf + par, elem="i"),
        F("alGetBuffer3i", "get_3", buf + par, elem="i"),
        F("alGetBufferiv", "get_v", buf + par, elem="i"),
        F("alGenBuffers", "gen_obj", []),
        F("alDeleteBuffers", "del_obj", []),
        F("alIsBuffer", "is_obj", [("I", "buffer")]),
    ]

    # --- global state -------------------------------------------------------------
    fns += [
        F("alEnable", "void", [("e", "capability")]),
        F("alDisable", "void", [("e", "capability")]),
        F("alIsEnabled", "is_obj", [("e", "capability")]),
        F("alGetBoolean", "ret_long", par, ret="ALboolean"),
        F("alGetInteger", "ret_long", par, ret="ALint"),
        F("alGetFloat", "ret_double", par, ret="ALfloat"),
        F("alGetDouble", "ret_double", par, ret="ALdouble"),
        F("alGetBooleanv", "get_v", par, elem="b", vlen=1, py="alGetBooleanv"),
        F("alGetIntegerv", "get_v", par, elem="i", vlen=1),
        F("alGetFloatv", "get_v", par, elem="f", vlen=1),
        F("alGetDoublev", "get_v", par, elem="d", vlen=1),
        F("alDistanceModel", "void", [("e", "model")]),
        F("alDopplerFactor", "void", [("f", "value")]),
        F("alDopplerVelocity", "void", [("f", "value")]),
        F("alSpeedOfSound", "void", [("f", "value")]),
        F("alGetStringiSOFT", "ret_string", par + [("z", "index")]),
        F("alDeferUpdatesSOFT", "void", []),
        F("alProcessUpdatesSOFT", "void", []),
    ]

    # --- EFX objects ------------------------------------------------------------
    for obj, arg in (("Effect", "effect"), ("Filter", "filter")):
        o = [("I", arg)]
        fns += [
            F(f"al{obj}f", "void", o + par + [("f", "value")]),
            F(f"al{obj}fv", "set_v", o + par, elem="f"),
            F(f"al{obj}i", "void", o + par + [("i", "value")]),
            F(f"al{obj}iv", "set_v", o + par, elem="i"),
            F(f"alGet{obj}f", "get_scalar", o + par, elem="f"),
            F(f"alGet{obj}fv", "get_v", o + par, elem="f"),
            F(f"alGet{obj}i", "get_scalar", o + par, elem="i"),
            F(f"alGet{obj}iv", "get_v", o + par, elem="i"),
            F(f"alGen{obj}s", "gen_obj", []),
            F(f"alDelete{obj}s", "del_obj", []),
            F(f"alIs{obj}", "is_obj", o),
        ]
    slot = [("I", "slot")]
    fns += [
        F("alAuxiliaryEffectSlotf", "void", slot + par + [("f", "value")]),
        F("alAuxiliaryEffectSlotfv", "set_v", slot + par, elem="f"),
        F("alAuxiliaryEffectSloti", "void", slot + par + [("i", "value")]),
        F("alAuxiliaryEffectSlotiv", "set_v", slot + par, elem="i"),
        F("alGetAuxiliaryEffectSlotf", "get_scalar", slot + par, elem="f"),
        F("alGetAuxiliaryEffectSlotfv", "get_v", slot + par, elem="f"),
        F("alGetAuxiliaryEffectSloti", "get_scalar", slot + par, elem="i"),
        F("alGetAuxiliaryEffectSlotiv", "get_v", slot + par, elem="i"),
        F("alGenAuxiliaryEffectSlots", "gen_obj", []),
        F("alDeleteAuxiliaryEffectSlots", "del_obj", []),
        F("alIsAuxiliaryEffectSlot", "is_obj", slot),
    ]

    # Debug/event entry points carry strings, id arrays, or function
    # pointers: hand-marshalled in alc_shim.cpp.
    fns += [
        F("alPopDebugGroupEXT", "void", []),
    ]

    return fns


def main():
    out = [HEADER]
    for fn in functions():
        out.append(emit(fn, direct=False))
        if fn.direct and fn.name.startswith("al"):
            out.append(emit(fn, direct=True))
    out.append(FOOTER)
    print("\n".join(out))


if __name__ == "__main__":
    main()
