/* C ABI shim: the classic OpenAL export surface over the PyTorch renderer.
 *
 * Builds libopenal_torch.so with the reference's entry-point names and C
 * signatures (alc/export_list.h), embedding CPython and forwarding to
 * openal_soft_tpu_torch.al.api.  A C/C++ application written against
 * OpenAL Soft's headers links against this instead of libopenal.so and
 * renders on the torch device that $OPENAL_TORCH_DEVICE names ("cuda",
 * the card, by default; "cpu" must be asked for).  An open on a device
 * that is not there returns NULL with the Python error printed; it never
 * falls back to another device.
 *
 * This file holds the hand-marshalled entries (device/context lifecycle,
 * render, capture, buffer data, strings, proc addresses, EAX, X-RAM,
 * callback bridges); the mechanical get/set matrix and every *Direct
 * variant are emitted into shim_generated.cpp by gen_shim.py.
 *
 * Threading: entry points grab the GIL via PyGILState; the embedded
 * interpreter is initialized lazily on the first device open.
 */

#include "shim_runtime.h"

#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>

using ALCdevice = void;
using ALCcontext = void;
using ALenum = int;
using ALuint = unsigned int;
using ALint = int;
using ALsizei = int;
using ALfloat = float;
using ALboolean = char;
using ALchar = char;
using ALCboolean = char;
using ALCenum = int;
using ALCint = int;
using ALCuint = unsigned int;
using ALCsizei = int;
using ALCchar = char;
using ALvoid = void;
using ALCvoid = void;
using ALint64SOFT = long long;
using ALuint64SOFT = unsigned long long;
using ALbitfieldSOFT = unsigned int;

using shim::Gil;
using shim::call;
using shim::call_on_device;
using shim::call_long;
using shim::call_double;
using shim::call_void;
using shim::call_string;
using shim::ensure_init;
using shim::g_api;

namespace {

/* 16-byte COM GUID -> canonical lowercase string (EAX property sets are
 * dispatched by GUID string on the Python side, al/eax/api.cpp). */
struct ShimGuid {
    uint32_t d1;
    uint16_t d2, d3;
    uint8_t d4[8];
};

void guid_to_str(const ShimGuid *g, char out[40])
{
    snprintf(out, 40,
             "%08x-%04x-%04x-%02x%02x-%02x%02x%02x%02x%02x%02x",
             g->d1, g->d2, g->d3, g->d4[0], g->d4[1], g->d4[2], g->d4[3],
             g->d4[4], g->d4[5], g->d4[6], g->d4[7]);
}

} // namespace

extern "C" {

/* ==== ALC device / context lifecycle (alc/alc.cpp) ======================= */

ALCdevice *alcOpenDevice(const ALCchar *devname)
{
    ensure_init();
    Gil gil;
    PyObject *args = devname ? Py_BuildValue("(s)", devname) : PyTuple_New(0);
    return static_cast<ALCdevice*>(call_on_device("alcOpenDevice", args));
}

ALCboolean alcCloseDevice(ALCdevice *device)
{
    Gil gil;
    call_void("alcCloseDevice",
              Py_BuildValue("(O)", static_cast<PyObject*>(device)));
    Py_XDECREF(static_cast<PyObject*>(device));
    return 1;
}

ALCdevice *alcLoopbackOpenDeviceSOFT(const ALCchar * /*devname*/)
{
    ensure_init();
    Gil gil;
    /* Opens at 48 kHz stereo float; the ALC_FORMAT_* / ALC_FREQUENCY /
     * ALC_HRTF_SOFT / ALC_MONO_SOURCES attributes of the first
     * alcCreateContext re-shape it, as in the reference. */
    PyObject *dev = call_on_device("alcLoopbackOpenDeviceSOFT",
                                   PyTuple_New(0));
    return static_cast<ALCdevice*>(dev);
}

ALCboolean alcIsRenderFormatSupportedSOFT(ALCdevice *, ALCsizei freq,
                                          ALCenum channels, ALCenum type)
{
    /* Loopback format negotiation (alc/alc.cpp:3443): the renderer
     * serves the full ALC_*_SOFT format matrix. */
    return freq >= 8000 && freq <= 192000 && channels != 0 && type != 0;
}

ALCcontext *alcCreateContext(ALCdevice *device, const ALCint *attrs)
{
    Gil gil;
    /* The zero-terminated attribute list, as a flat Python list of ints. */
    PyObject *alist = PyList_New(0);
    for(const ALCint *a = attrs; a && a[0]; a += 2) {
        PyObject *k = PyLong_FromLong(a[0]), *v = PyLong_FromLong(a[1]);
        PyList_Append(alist, k);
        PyList_Append(alist, v);
        Py_DECREF(k);
        Py_DECREF(v);
    }
    PyObject *args = Py_BuildValue("(ON)", static_cast<PyObject*>(device),
                                   alist);
    PyObject *ctx = call("alcCreateContext", args);
    return static_cast<ALCcontext*>(ctx);
}

void alcDestroyContext(ALCcontext *context)
{
    Gil gil;
    Py_XDECREF(static_cast<PyObject*>(context));
}

ALCboolean alcMakeContextCurrent(ALCcontext *context)
{
    Gil gil;
    PyObject *args = Py_BuildValue("(O)",
        context ? static_cast<PyObject*>(context) : Py_None);
    call_void("alcMakeContextCurrent", args);
    return 1;
}

ALCboolean alcSetThreadContext(ALCcontext *context)
{
    /* ALC_EXT_thread_local_context: the Python current-context store is
     * already thread-local. */
    return alcMakeContextCurrent(context);
}

ALCcontext *alcGetCurrentContext(void)
{
    if(!g_api) return nullptr;
    Gil gil;
    PyObject *r = call("alcGetCurrentContext", PyTuple_New(0));
    if(r == Py_None) { Py_DECREF(r); return nullptr; }
    /* borrowed-style: the context is owned by the app via create */
    Py_XDECREF(r);
    return static_cast<ALCcontext*>(r);
}

ALCcontext *alcGetThreadContext(void)
{
    return alcGetCurrentContext();
}

ALCdevice *alcGetContextsDevice(ALCcontext *context)
{
    Gil gil;
    PyObject *ctx = static_cast<PyObject*>(context);
    if(!ctx) return nullptr;
    PyObject *dev = PyObject_GetAttrString(ctx, "device");
    Py_XDECREF(dev);   /* borrowed-style: owned by the context */
    return static_cast<ALCdevice*>(dev);
}

void alcProcessContext(ALCcontext * /*context*/) {}
void alcSuspendContext(ALCcontext * /*context*/) {}

void alcRenderSamplesSOFT(ALCdevice *device, void *buffer, ALCsizei samples)
{
    Gil gil;
    PyObject *args = Py_BuildValue("(Oi)", static_cast<PyObject*>(device),
                                   static_cast<int>(samples));
    PyObject *out = call("alcRenderSamplesSOFT", args);
    if(!out) return;
    /* numpy array -> raw bytes via the buffer protocol */
    Py_buffer view;
    if(PyObject_GetBuffer(out, &view, PyBUF_CONTIG_RO) == 0) {
        memcpy(buffer, view.buf, static_cast<size_t>(view.len));
        PyBuffer_Release(&view);
    } else {
        PyErr_Print();
    }
    Py_DECREF(out);
}

void alcDevicePauseSOFT(ALCdevice *device)
{
    Gil gil;
    call_void("alcDevicePauseSOFT",
              Py_BuildValue("(O)", static_cast<PyObject*>(device)));
}

void alcDeviceResumeSOFT(ALCdevice *device)
{
    Gil gil;
    call_void("alcDeviceResumeSOFT",
              Py_BuildValue("(O)", static_cast<PyObject*>(device)));
}

ALCboolean alcResetDeviceSOFT(ALCdevice *device, const ALCint * /*attribs*/)
{
    Gil gil;
    call_void("alcResetDeviceSOFT",
              Py_BuildValue("(O)", static_cast<PyObject*>(device)));
    return 1;
}

ALCboolean alcReopenDeviceSOFT(ALCdevice *device, const ALCchar *devname,
                               const ALCint * /*attribs*/)
{
    Gil gil;
    PyObject *args = Py_BuildValue("(Os)", static_cast<PyObject*>(device),
                                   devname ? devname : "");
    call_void("alcReopenDeviceSOFT", args);
    return 1;
}

/* ==== ALC capture (alc/alc.cpp:3175-3360) ================================ */

ALCdevice *alcCaptureOpenDevice(const ALCchar *devname, ALCuint frequency,
                                ALCenum format, ALCsizei buffersize)
{
    ensure_init();
    Gil gil;
    PyObject *args = Py_BuildValue("(sIii)", devname ? devname : "",
                                   frequency, static_cast<int>(format),
                                   static_cast<int>(buffersize));
    return static_cast<ALCdevice*>(call("alcCaptureOpenDeviceByName", args));
}

ALCboolean alcCaptureCloseDevice(ALCdevice *device)
{
    Gil gil;
    call_void("alcCaptureCloseDevice",
              Py_BuildValue("(O)", static_cast<PyObject*>(device)));
    Py_XDECREF(static_cast<PyObject*>(device));
    return 1;
}

void alcCaptureStart(ALCdevice *device)
{
    Gil gil;
    call_void("alcCaptureStart",
              Py_BuildValue("(O)", static_cast<PyObject*>(device)));
}

void alcCaptureStop(ALCdevice *device)
{
    Gil gil;
    call_void("alcCaptureStop",
              Py_BuildValue("(O)", static_cast<PyObject*>(device)));
}

void alcCaptureSamples(ALCdevice *device, ALCvoid *buffer, ALCsizei samples)
{
    Gil gil;
    PyObject *args = Py_BuildValue("(Oi)", static_cast<PyObject*>(device),
                                   static_cast<int>(samples));
    PyObject *out = call("alcCaptureSamplesRaw", args);
    if(!out) return;
    Py_buffer view;
    if(PyObject_GetBuffer(out, &view, PyBUF_CONTIG_RO) == 0) {
        memcpy(buffer, view.buf, static_cast<size_t>(view.len));
        PyBuffer_Release(&view);
    } else {
        PyErr_Print();
    }
    Py_DECREF(out);
}

/* ==== ALC queries ========================================================= */

const ALCchar *alcGetString(ALCdevice *device, ALCenum param)
{
    ensure_init();
    Gil gil;
    PyObject *args = Py_BuildValue("(Oi)",
        device ? static_cast<PyObject*>(device) : Py_None,
        static_cast<int>(param));
    return call_string("alcGetString", args);
}

void alcGetIntegerv(ALCdevice *device, ALCenum param, ALCsizei size,
                    ALCint *values)
{
    Gil gil;
    PyObject *args = Py_BuildValue("(Oi)",
        device ? static_cast<PyObject*>(device) : Py_None,
        static_cast<int>(param));
    PyObject *r = call("alcGetIntegerv", args);
    if(!r) return;
    if(PyLong_Check(r) && size >= 1)
        values[0] = static_cast<ALCint>(PyLong_AsLong(r));
    else if(PyList_Check(r)) {
        Py_ssize_t got = PyList_GET_SIZE(r);
        for(Py_ssize_t i = 0; i < got && i < size; ++i)
            values[i] = static_cast<ALCint>(
                PyLong_AsLong(PyList_GET_ITEM(r, i)));
    }
    Py_XDECREF(r);
}

void alcGetInteger64vSOFT(ALCdevice *device, ALCenum param, ALCsizei size,
                          ALint64SOFT *values)
{
    Gil gil;
    PyObject *args = Py_BuildValue("(Oi)",
        device ? static_cast<PyObject*>(device) : Py_None,
        static_cast<int>(param));
    PyObject *r = call("alcGetInteger64vSOFT", args);
    if(!r) return;
    if(PyLong_Check(r) && size >= 1)
        values[0] = PyLong_AsLongLong(r);
    else if(PyTuple_Check(r)) {
        Py_ssize_t got = PyTuple_GET_SIZE(r);
        for(Py_ssize_t i = 0; i < got && i < size; ++i)
            values[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(r, i));
    }
    Py_XDECREF(r);
}

ALCenum alcGetError(ALCdevice * /*device*/)
{
    return 0;   /* ALC errors surface as AL errors in this build */
}

ALCboolean alcIsExtensionPresent(ALCdevice *device, const ALCchar *extname)
{
    ensure_init();
    Gil gil;
    PyObject *args = Py_BuildValue("(Os)",
        device ? static_cast<PyObject*>(device) : Py_None, extname);
    return static_cast<ALCboolean>(call_long("alcIsExtensionPresent", args));
}

ALCenum alcGetEnumValue(ALCdevice *device, const ALCchar *enumname)
{
    ensure_init();
    Gil gil;
    PyObject *args = Py_BuildValue("(Os)",
        device ? static_cast<PyObject*>(device) : Py_None, enumname);
    return static_cast<ALCenum>(call_long("alcGetEnumValue", args));
}

/* Proc-address lookups resolve against this shared object itself. */
void *alcGetProcAddress(ALCdevice *, const ALCchar *funcname);
void *alGetProcAddress(const ALchar *funcname);

/* ==== AL queries ========================================================== */

ALenum alGetError(void)
{
    if(!g_api) return 0;
    Gil gil;
    return static_cast<ALenum>(call_long("alGetError", PyTuple_New(0)));
}

const ALchar *alGetString(ALenum param)
{
    ensure_init();
    Gil gil;
    return call_string("alGetString",
                       Py_BuildValue("(i)", static_cast<int>(param)));
}

ALboolean alIsExtensionPresent(const ALchar *extname)
{
    ensure_init();
    Gil gil;
    return static_cast<ALboolean>(
        call_long("alIsExtensionPresent", Py_BuildValue("(s)", extname)));
}

ALenum alGetEnumValue(const ALchar *ename)
{
    ensure_init();
    Gil gil;
    return static_cast<ALenum>(
        call_long("alGetEnumValue", Py_BuildValue("(s)", ename)));
}

/* Direct variants of the hand-written query entry points (the generated
 * table covers the rest; these take pointer/string payloads). */
ALenum alGetErrorDirect(ALCcontext *context)
{
    ensure_init();
    Gil gil;
    return static_cast<ALenum>(call_long(
        "alDirectCall", Py_BuildValue("(sO)", "alGetError",
                                      static_cast<PyObject*>(context))));
}

const ALchar *alGetStringDirect(ALCcontext *context, ALenum param)
{
    ensure_init();
    Gil gil;
    return call_string(
        "alDirectCall", Py_BuildValue("(sOi)", "alGetString",
                                      static_cast<PyObject*>(context),
                                      static_cast<int>(param)));
}

ALboolean alIsExtensionPresentDirect(ALCcontext *context,
                                     const ALchar *extname)
{
    ensure_init();
    Gil gil;
    return static_cast<ALboolean>(call_long(
        "alDirectCall", Py_BuildValue("(sOs)", "alIsExtensionPresent",
                                      static_cast<PyObject*>(context),
                                      extname)));
}

ALenum alGetEnumValueDirect(ALCcontext *context, const ALchar *ename)
{
    ensure_init();
    Gil gil;
    return static_cast<ALenum>(call_long(
        "alDirectCall", Py_BuildValue("(sOs)", "alGetEnumValue",
                                      static_cast<PyObject*>(context),
                                      ename)));
}

/* ==== buffer data ========================================================= */

void alBufferData(ALuint buffer, ALenum format, const ALvoid *data,
                  ALsizei size, ALsizei freq)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), size);
    /* api.alBufferDataRaw decodes the byte payload per the AL format. */
    PyObject *args = Py_BuildValue("(IiNi)", buffer,
                                   static_cast<int>(format), bytes,
                                   static_cast<int>(freq));
    call_void("alBufferDataRaw", args);
}

void alBufferDataDirect(ALCcontext *context, ALuint buffer, ALenum format,
                        const ALvoid *data, ALsizei size, ALsizei freq)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), size);
    PyObject *args = Py_BuildValue("(sOIiNi)", "alBufferDataRaw",
                                   static_cast<PyObject*>(context), buffer,
                                   static_cast<int>(format), bytes,
                                   static_cast<int>(freq));
    call_void("alDirectCall", args);
}

void alBufferSubDataSOFT(ALuint buffer, ALenum format, const ALvoid *data,
                         ALsizei offset, ALsizei length)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), length);
    call_void("alBufferSubDataRawSOFT",
              Py_BuildValue("(IiNi)", buffer, static_cast<int>(format),
                            bytes, static_cast<int>(offset)));
}

void *alMapBufferSOFT(ALuint buffer, ALsizei offset, ALsizei length,
                      ALenum /*access*/)
{
    Gil gil;
    PyObject *r = call("alMapBufferSOFT",
                       Py_BuildValue("(Iii)", buffer,
                                     static_cast<int>(offset),
                                     static_cast<int>(length)));
    if(!r) return nullptr;
    Py_buffer view;
    void *ptr = nullptr;
    if(PyObject_GetBuffer(r, &view, PyBUF_CONTIG) == 0) {
        ptr = view.buf;            /* backed by the buffer's host storage */
        PyBuffer_Release(&view);
    }
    Py_DECREF(r);
    return ptr;
}

void alUnmapBufferSOFT(ALuint buffer)
{
    Gil gil;
    call_void("alUnmapBufferSOFT", Py_BuildValue("(I)", buffer));
}

void alFlushMappedBufferSOFT(ALuint buffer, ALsizei offset, ALsizei length)
{
    Gil gil;
    call_void("alFlushMappedBufferSOFT",
              Py_BuildValue("(Iii)", buffer, static_cast<int>(offset),
                            static_cast<int>(length)));
}

/* ==== AL_SOFT_callback_buffer (al/buffer.cpp:874) ========================= */

namespace {

using BufferCallback = ALsizei (*)(void *userptr, void *sampledata,
                                   ALsizei numbytes);

struct BufCb {
    BufferCallback fn;
    void *user;
    int frame_bytes;
};
std::map<ALuint, BufCb> g_buf_cbs;
std::mutex g_buf_cbs_mu;

int format_frame_bytes(ALenum format)
{
    /* channels x sample bytes for the callback-capable formats
     * (al/buffer.cpp:FmtFromUserFmt); callback buffers reject compressed
     * block formats, so byte-per-frame is exact. */
    switch(format) {
    case 0x1100: return 1;           /* AL_FORMAT_MONO8 */
    case 0x1101: return 2;           /* AL_FORMAT_MONO16 */
    case 0x10010: return 4;          /* AL_FORMAT_MONO_FLOAT32 */
    case 0x1102: return 2;           /* AL_FORMAT_STEREO8 */
    case 0x1103: return 4;           /* AL_FORMAT_STEREO16 */
    case 0x10011: return 8;          /* AL_FORMAT_STEREO_FLOAT32 */
    default: return 4;
    }
}

/* Python pulls `tramp(frames)`; the C callback fills raw bytes which the
 * host-side feeder decodes per the registered format. */
PyObject *buffer_cb_tramp(PyObject *self, PyObject *args)
{
    int frames;
    if(!PyArg_ParseTuple(args, "i", &frames))
        return nullptr;
    ALuint buffer = static_cast<ALuint>(PyLong_AsUnsignedLong(self));
    BufCb cb{};
    {
        std::lock_guard<std::mutex> lock(g_buf_cbs_mu);
        auto it = g_buf_cbs.find(buffer);
        if(it == g_buf_cbs.end()) return PyBytes_FromStringAndSize("", 0);
        cb = it->second;
    }
    ALsizei numbytes = frames * cb.frame_bytes;
    PyObject *out = PyBytes_FromStringAndSize(nullptr, numbytes);
    if(!out) return nullptr;
    ALsizei got = 0;
    Py_BEGIN_ALLOW_THREADS
    got = cb.fn(cb.user, PyBytes_AS_STRING(out), numbytes);
    Py_END_ALLOW_THREADS
    if(got < 0) got = 0;
    if(got > numbytes) got = numbytes;
    got -= got % cb.frame_bytes;
    _PyBytes_Resize(&out, got);
    return out;
}

PyMethodDef g_buffer_cb_tramp_def = {"_shim_buffer_cb_tramp",
                                     buffer_cb_tramp, METH_VARARGS, nullptr};

} // namespace

void alBufferCallbackSOFT(ALuint buffer, ALenum format, ALsizei freq,
                          BufferCallback callback, void *userptr)
{
    Gil gil;
    {
        std::lock_guard<std::mutex> lock(g_buf_cbs_mu);
        if(callback)
            g_buf_cbs[buffer] = BufCb{callback, userptr,
                                      format_frame_bytes(format)};
        else
            g_buf_cbs.erase(buffer);
    }
    PyObject *self = PyLong_FromUnsignedLong(buffer);
    PyObject *cb = callback
        ? PyCFunction_New(&g_buffer_cb_tramp_def, self) : Py_NewRef(Py_None);
    Py_XDECREF(self);
    call_void("alBufferCallbackSOFT",
              Py_BuildValue("(IiiN)", buffer, static_cast<int>(format),
                            static_cast<int>(freq), cb));
}

void alBufferCallbackDirectSOFT(ALCcontext *context, ALuint buffer,
                                ALenum format, ALsizei freq,
                                BufferCallback callback, void *userptr)
{
    Gil gil;
    {
        std::lock_guard<std::mutex> lock(g_buf_cbs_mu);
        if(callback)
            g_buf_cbs[buffer] = BufCb{callback, userptr,
                                      format_frame_bytes(format)};
        else
            g_buf_cbs.erase(buffer);
    }
    PyObject *self = PyLong_FromUnsignedLong(buffer);
    PyObject *cb = callback
        ? PyCFunction_New(&g_buffer_cb_tramp_def, self) : Py_NewRef(Py_None);
    Py_XDECREF(self);
    call_void("alDirectCall",
              Py_BuildValue("(sOIiiN)", "alBufferCallbackSOFT",
                            static_cast<PyObject*>(context), buffer,
                            static_cast<int>(format), static_cast<int>(freq),
                            cb));
}

/* Callback-buffer pointer queries (al/buffer.cpp alGetBufferPtrSOFT). */
void alGetBufferPtrSOFT(ALuint buffer, ALenum param, void **ptr)
{
    std::lock_guard<std::mutex> lock(g_buf_cbs_mu);
    auto it = g_buf_cbs.find(buffer);
    if(param == 0x19A0)          /* AL_BUFFER_CALLBACK_FUNCTION_SOFT */
        *ptr = it != g_buf_cbs.end()
            ? reinterpret_cast<void*>(it->second.fn) : nullptr;
    else if(param == 0x19A1)     /* AL_BUFFER_CALLBACK_USER_PARAM_SOFT */
        *ptr = it != g_buf_cbs.end() ? it->second.user : nullptr;
    else
        *ptr = nullptr;
}

void alGetBuffer3PtrSOFT(ALuint buffer, ALenum param, void **p0, void **p1,
                         void **p2)
{
    /* No 3-pointer buffer properties exist; zero-fill like the reference's
     * invalid-enum path (al/buffer.cpp). */
    (void)buffer; (void)param;
    if(p0) *p0 = nullptr;
    if(p1) *p1 = nullptr;
    if(p2) *p2 = nullptr;
}

void alGetBufferPtrvSOFT(ALuint buffer, ALenum param, void **values)
{
    alGetBufferPtrSOFT(buffer, param, values);
}

/* ==== X-RAM (al/eax/x_ram.h) ============================================== */

ALboolean alEAXSetBufferMode(ALsizei n, const ALuint *buffers, ALint value)
{
    Gil gil;
    PyObject *lst = PyList_New(n);
    for(ALsizei i = 0; i < n; ++i)
        PyList_SET_ITEM(lst, i, PyLong_FromUnsignedLong(buffers[i]));
    return static_cast<ALboolean>(call_long(
        "alEAXSetBufferMode", Py_BuildValue("(Ni)", lst,
                                            static_cast<int>(value)), 1));
}

ALenum alEAXGetBufferMode(ALuint buffer, ALint *reserved)
{
    if(reserved) *reserved = 0;
    Gil gil;
    return static_cast<ALenum>(call_long(
        "alEAXGetBufferMode", Py_BuildValue("(I)", buffer)));
}

/* Canonical X-RAM export names (al/eax/x_ram.h exports them without the
 * "al" prefix) plus their direct-context variants. */
ALboolean EAXSetBufferMode(ALsizei n, const ALuint *buffers, ALint value)
{
    return alEAXSetBufferMode(n, buffers, value);
}

ALenum EAXGetBufferMode(ALuint buffer, ALint *reserved)
{
    return alEAXGetBufferMode(buffer, reserved);
}

ALboolean EAXSetBufferModeDirect(ALCcontext *context, ALsizei n,
                                 const ALuint *buffers, ALint value)
{
    Gil gil;
    PyObject *lst = PyList_New(n);
    for(ALsizei i = 0; i < n; ++i)
        PyList_SET_ITEM(lst, i, PyLong_FromUnsignedLong(buffers[i]));
    return static_cast<ALboolean>(call_long(
        "alDirectCall", Py_BuildValue("(sONi)", "alEAXSetBufferMode",
                                      static_cast<PyObject*>(context), lst,
                                      static_cast<int>(value)), 1));
}

ALenum EAXGetBufferModeDirect(ALCcontext *context, ALuint buffer,
                              ALint *reserved)
{
    if(reserved) *reserved = 0;
    Gil gil;
    return static_cast<ALenum>(call_long(
        "alDirectCall", Py_BuildValue("(sOI)", "alEAXGetBufferMode",
                                      static_cast<PyObject*>(context),
                                      buffer)));
}

/* ==== EAXSet / EAXGet (al/eax/api.cpp ABI) ================================ */

ALenum EAXSet(const void *property_set_id, ALuint property_id,
              ALuint source, ALvoid *value, ALuint size)
{
    Gil gil;
    char guid[40];
    guid_to_str(static_cast<const ShimGuid*>(property_set_id), guid);
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(value), size);
    return static_cast<ALenum>(call_long(
        "EAXSetRaw", Py_BuildValue("(sIIN)", guid, property_id, source,
                                   bytes)));
}

ALenum EAXGet(const void *property_set_id, ALuint property_id,
              ALuint source, ALvoid *value, ALuint size)
{
    Gil gil;
    char guid[40];
    guid_to_str(static_cast<const ShimGuid*>(property_set_id), guid);
    PyObject *r = call("EAXGetRaw",
                       Py_BuildValue("(sIII)", guid, property_id, source,
                                     size));
    ALenum err = 0;
    if(r && PyBytes_Check(r)) {
        Py_ssize_t n = PyBytes_GET_SIZE(r);
        if(static_cast<ALuint>(n) > size) n = size;
        memcpy(value, PyBytes_AS_STRING(r), static_cast<size_t>(n));
    } else {
        err = 0xA002;   /* AL_INVALID_ENUM */
    }
    Py_XDECREF(r);
    return err;
}

/* EAXSetDirect/EAXGetDirect route through the same raw marshalling with an
 * explicit context (al/direct_defs.h EAX rows). */
ALenum EAXSetDirect(ALCcontext *context, const void *psid, ALuint pid,
                    ALuint source, ALvoid *value, ALuint size)
{
    Gil gil;
    char guid[40];
    guid_to_str(static_cast<const ShimGuid*>(psid), guid);
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(value), size);
    return static_cast<ALenum>(call_long(
        "alDirectCall", Py_BuildValue("(sOsIIN)", "EAXSetRaw",
                                      static_cast<PyObject*>(context), guid,
                                      pid, source, bytes)));
}

ALenum EAXGetDirect(ALCcontext *context, const void *psid, ALuint pid,
                    ALuint source, ALvoid *value, ALuint size)
{
    Gil gil;
    char guid[40];
    guid_to_str(static_cast<const ShimGuid*>(psid), guid);
    PyObject *r = call("alDirectCall",
                       Py_BuildValue("(sOsIII)", "EAXGetRaw",
                                     static_cast<PyObject*>(context), guid,
                                     pid, source, size));
    ALenum err = 0;
    if(r && PyBytes_Check(r)) {
        Py_ssize_t n = PyBytes_GET_SIZE(r);
        if(static_cast<ALuint>(n) > size) n = size;
        memcpy(value, PyBytes_AS_STRING(r), static_cast<size_t>(n));
    } else {
        err = 0xA002;
    }
    Py_XDECREF(r);
    return err;
}

/* ==== callback bridges (AL_SOFT_events / AL_EXT_debug) ==================== */

namespace {

using EventProc = void (*)(ALenum, ALuint, ALuint, ALsizei, const ALchar*,
                           void*);
using DebugProc = void (*)(ALenum, ALenum, ALuint, ALenum, ALsizei,
                           const ALchar*, void*);

struct CbState {
    EventProc event_fn = nullptr;
    void *event_user = nullptr;
    DebugProc debug_fn = nullptr;
    void *debug_user = nullptr;
};
CbState g_cbs;

/* Python event kinds -> AL_EVENT_TYPE_* enums. */
int event_enum(const char *kind)
{
    if(!strcmp(kind, "buffer_completed")) return 0x19A4;
    if(!strcmp(kind, "source_state")) return 0x19A5;
    if(!strcmp(kind, "disconnected")) return 0x19A6;
    return 0;
}

PyObject *event_tramp(PyObject *, PyObject *args)
{
    const char *kind;
    unsigned object;
    PyObject *param;
    if(!PyArg_ParseTuple(args, "sIO", &kind, &object, &param))
        return nullptr;
    EventProc fn = g_cbs.event_fn;
    void *user = g_cbs.event_user;
    if(fn) {
        char msg[256] = "";
        unsigned prm = 0;
        if(PyLong_Check(param))
            prm = static_cast<unsigned>(PyLong_AsUnsignedLongMask(param));
        else if(PyUnicode_Check(param)) {
            const char *s = PyUnicode_AsUTF8(param);
            if(s) { strncpy(msg, s, sizeof(msg)-1); msg[sizeof(msg)-1] = 0; }
        }
        Py_BEGIN_ALLOW_THREADS
        fn(event_enum(kind), object, prm,
           static_cast<ALsizei>(strlen(msg)), msg, user);
        Py_END_ALLOW_THREADS
    }
    Py_RETURN_NONE;
}

PyObject *debug_tramp(PyObject *, PyObject *args)
{
    int source, mtype, severity;
    unsigned mid;
    const char *message;
    if(!PyArg_ParseTuple(args, "iiIis", &source, &mtype, &mid, &severity,
                         &message))
        return nullptr;
    DebugProc fn = g_cbs.debug_fn;
    void *user = g_cbs.debug_user;
    if(fn) {
        Py_BEGIN_ALLOW_THREADS
        fn(source, mtype, mid, severity,
           static_cast<ALsizei>(strlen(message)), message, user);
        Py_END_ALLOW_THREADS
    }
    Py_RETURN_NONE;
}

PyMethodDef g_event_tramp_def = {"_shim_event_tramp", event_tramp,
                                 METH_VARARGS, nullptr};
PyMethodDef g_debug_tramp_def = {"_shim_debug_tramp", debug_tramp,
                                 METH_VARARGS, nullptr};

} // namespace

void alEventControlSOFT(ALsizei count, const ALenum *types, ALboolean enable)
{
    Gil gil;
    PyObject *lst = PyList_New(count);
    for(ALsizei i = 0; i < count; ++i)
        PyList_SET_ITEM(lst, i, PyLong_FromLong(types[i]));
    call_void("alEventControlSOFT",
              Py_BuildValue("(Ni)", lst, enable ? 1 : 0));
}

void alEventCallbackSOFT(EventProc callback, void *userParam)
{
    Gil gil;
    g_cbs.event_fn = callback;
    g_cbs.event_user = userParam;
    PyObject *cb = callback
        ? PyCFunction_New(&g_event_tramp_def, nullptr) : Py_NewRef(Py_None);
    call_void("alEventCallbackSOFT", Py_BuildValue("(N)", cb));
}

void alDebugMessageCallbackEXT(DebugProc callback, void *userParam)
{
    Gil gil;
    g_cbs.debug_fn = callback;
    g_cbs.debug_user = userParam;
    PyObject *cb = callback
        ? PyCFunction_New(&g_debug_tramp_def, nullptr) : Py_NewRef(Py_None);
    call_void("alDebugMessageCallbackEXT", Py_BuildValue("(N)", cb));
}

void alDebugMessageInsertEXT(ALenum source, ALenum type, ALuint id,
                             ALenum severity, ALsizei length,
                             const ALchar *message)
{
    Gil gil;
    call_void("alDebugMessageInsertEXT",
              Py_BuildValue("(iiIis#)", static_cast<int>(source),
                            static_cast<int>(type), id,
                            static_cast<int>(severity), message,
                            static_cast<Py_ssize_t>(
                                length >= 0 ? length
                                            : static_cast<ALsizei>(
                                                strlen(message)))));
}

void alDebugMessageControlEXT(ALenum source, ALenum type, ALenum severity,
                              ALsizei count, const ALuint *ids,
                              ALboolean enable)
{
    Gil gil;
    PyObject *lst = PyList_New(count);
    for(ALsizei i = 0; i < count; ++i)
        PyList_SET_ITEM(lst, i, PyLong_FromUnsignedLong(ids[i]));
    call_void("alDebugMessageControlEXT",
              Py_BuildValue("(iiiNi)", static_cast<int>(source),
                            static_cast<int>(type),
                            static_cast<int>(severity), lst,
                            enable ? 1 : 0));
}

void alPushDebugGroupEXT(ALenum source, ALuint id, ALsizei length,
                         const ALchar *message)
{
    Gil gil;
    call_void("alPushDebugGroupEXT",
              Py_BuildValue("(iIs#)", static_cast<int>(source), id, message,
                            static_cast<Py_ssize_t>(
                                length >= 0 ? length
                                            : static_cast<ALsizei>(
                                                strlen(message)))));
}

void alObjectLabelEXT(ALenum identifier, ALuint name, ALsizei length,
                      const ALchar *label)
{
    Gil gil;
    const char *kind = identifier == 0x19D4 ? "buffer" : "source";
    call_void("alObjectLabelEXT",
              Py_BuildValue("(sIs#)", kind, name, label,
                            static_cast<Py_ssize_t>(
                                length >= 0 ? length
                                            : static_cast<ALsizei>(
                                                strlen(label)))));
}

void alGetObjectLabelEXT(ALenum identifier, ALuint name, ALsizei bufSize,
                         ALsizei *length, ALchar *label)
{
    Gil gil;
    const char *kind = identifier == 0x19D4 ? "buffer" : "source";
    PyObject *r = call("alGetObjectLabelEXT",
                       Py_BuildValue("(sI)", kind, name));
    ALsizei n = 0;
    if(r && PyUnicode_Check(r)) {
        const char *s = PyUnicode_AsUTF8(r);
        if(s && label && bufSize > 0) {
            strncpy(label, s, static_cast<size_t>(bufSize) - 1);
            label[bufSize - 1] = 0;
            n = static_cast<ALsizei>(strlen(label));
        }
    }
    if(length) *length = n;
    Py_XDECREF(r);
}

/* ==== ALC_SOFT_system_events (alc/events.cpp) ============================= */

namespace {

using AlcEventProc = void (*)(ALCenum eventType, ALCenum deviceType,
                              ALCdevice *device, ALCsizei length,
                              const ALCchar *message, void *userParam);

AlcEventProc g_alc_event_fn = nullptr;
void *g_alc_event_user = nullptr;

PyObject *alc_event_tramp(PyObject *, PyObject *args)
{
    int etype, dtype;
    PyObject *device, *user;
    const char *message;
    if(!PyArg_ParseTuple(args, "iiOsO", &etype, &dtype, &device, &message,
                         &user))
        return nullptr;
    AlcEventProc fn = g_alc_event_fn;
    void *userp = g_alc_event_user;
    if(fn) {
        void *dev = device == Py_None ? nullptr
                                      : static_cast<void*>(device);
        Py_BEGIN_ALLOW_THREADS
        fn(etype, dtype, dev, static_cast<ALCsizei>(strlen(message)),
           message, userp);
        Py_END_ALLOW_THREADS
    }
    Py_RETURN_NONE;
}

PyMethodDef g_alc_event_tramp_def = {"_shim_alc_event_tramp",
                                     alc_event_tramp, METH_VARARGS, nullptr};

} // namespace

ALCboolean alcEventControlSOFT(ALCsizei count, const ALCenum *events,
                               ALCboolean enable)
{
    ensure_init();
    Gil gil;
    PyObject *lst = PyList_New(count);
    for(ALCsizei i = 0; i < count; ++i)
        PyList_SET_ITEM(lst, i, PyLong_FromLong(events[i]));
    return static_cast<ALCboolean>(call_long(
        "alcEventControlSOFT", Py_BuildValue("(Ni)", lst, enable ? 1 : 0)));
}

void alcEventCallbackSOFT(AlcEventProc callback, void *userParam)
{
    ensure_init();
    Gil gil;
    g_alc_event_fn = callback;
    g_alc_event_user = userParam;
    PyObject *cb = callback
        ? PyCFunction_New(&g_alc_event_tramp_def, nullptr)
        : Py_NewRef(Py_None);
    call_void("alcEventCallbackSOFT", Py_BuildValue("(N)", cb));
}

ALCenum alcEventIsSupportedSOFT(ALCenum eventType, ALCenum deviceType)
{
    ensure_init();
    Gil gil;
    return static_cast<ALCenum>(call_long(
        "alcEventIsSupportedSOFT",
        Py_BuildValue("(ii)", static_cast<int>(eventType),
                      static_cast<int>(deviceType))));
}

const ALCchar *alcGetStringiSOFT(ALCdevice *device, ALCenum param,
                                 ALCsizei index)
{
    ensure_init();
    Gil gil;
    PyObject *args = Py_BuildValue("(Oii)",
        device ? static_cast<PyObject*>(device) : Py_None,
        static_cast<int>(param), static_cast<int>(index));
    return call_string("alcGetStringiSOFT", args);
}

/* ==== AL_EXT_debug message log + pointer queries ========================== */

ALuint alGetDebugMessageLogEXT(ALuint count, ALsizei logBufSize,
                               ALenum *sources, ALenum *types, ALuint *ids,
                               ALenum *severities, ALsizei *lengths,
                               ALchar *logBuf)
{
    Gil gil;
    PyObject *r = call("alGetDebugMessageLogEXT",
                       Py_BuildValue("(I)", count));
    if(!r || !PyList_Check(r)) { Py_XDECREF(r); return 0; }
    ALuint written = 0;
    ALsizei bufpos = 0;
    Py_ssize_t n = PyList_GET_SIZE(r);
    for(Py_ssize_t i = 0; i < n; ++i) {
        PyObject *t = PyList_GET_ITEM(r, i);
        int src = 0, mtype = 0, sev = 0;
        unsigned mid = 0;
        const char *msg = "";
        if(!PyArg_ParseTuple(t, "iiIis", &src, &mtype, &mid, &sev, &msg)) {
            PyErr_Clear();
            continue;
        }
        ALsizei mlen = static_cast<ALsizei>(strlen(msg)) + 1;
        if(logBuf && bufpos + mlen > logBufSize)
            break;
        if(sources) sources[written] = src;
        if(types) types[written] = mtype;
        if(ids) ids[written] = mid;
        if(severities) severities[written] = sev;
        if(lengths) lengths[written] = mlen;
        if(logBuf) {
            memcpy(logBuf + bufpos, msg, static_cast<size_t>(mlen));
            bufpos += mlen;
        }
        ++written;
    }
    Py_DECREF(r);
    return written;
}

void *alGetPointerEXT(ALenum pname)
{
    switch(pname) {
    case 0x19A2:    /* AL_EVENT_CALLBACK_FUNCTION_SOFT */
        return reinterpret_cast<void*>(g_cbs.event_fn);
    case 0x19A3:    /* AL_EVENT_CALLBACK_USER_PARAM_SOFT */
        return g_cbs.event_user;
    case 0x19B3:    /* AL_DEBUG_CALLBACK_FUNCTION_EXT */
        return reinterpret_cast<void*>(g_cbs.debug_fn);
    case 0x19B4:    /* AL_DEBUG_CALLBACK_USER_PARAM_EXT */
        return g_cbs.debug_user;
    default:
        return nullptr;
    }
}

void *alGetPointerSOFT(ALenum pname) { return alGetPointerEXT(pname); }

void alGetPointervEXT(ALenum pname, void **values)
{
    if(values) *values = alGetPointerEXT(pname);
}

void alGetPointervSOFT(ALenum pname, void **values)
{
    alGetPointervEXT(pname, values);
}

/* ==== AL_SOFT_source_start_delay (v form) ================================= */

void alSourcePlayAtTimevSOFT(ALsizei n, const ALuint *sources,
                             ALint64SOFT start_time)
{
    Gil gil;
    for(ALsizei k = 0; k < n; ++k)
        call_void("alSourcePlayAtTimeSOFT",
                  Py_BuildValue("(IL)", sources[k],
                                static_cast<long long>(start_time)));
}

/* ==== AL_SOFT_buffer_storage / AL_EXT_STATIC_BUFFER ======================= */

void alBufferStorageSOFT(ALuint buffer, ALenum format, const ALvoid *data,
                         ALsizei size, ALsizei freq, ALbitfieldSOFT flags)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), size);
    call_void("alBufferStorageSOFT",
              Py_BuildValue("(IiNiI)", buffer, static_cast<int>(format),
                            bytes, static_cast<int>(freq),
                            static_cast<unsigned>(flags)));
}

void alBufferDataStatic(ALuint buffer, ALenum format, ALvoid *data,
                        ALsizei size, ALsizei freq)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), size);
    call_void("alBufferDataStatic",
              Py_BuildValue("(IiNi)", buffer, static_cast<int>(format),
                            bytes, static_cast<int>(freq)));
}

/* ==== Direct variants of the hand-written entries ========================= */
/* AL_EXT_direct_context (al/direct_defs.h): explicit-context routing of
 * every pointer/string-payload entry point alDirectCall can't generate. */

void alBufferSubDataDirectSOFT(ALCcontext *context, ALuint buffer,
                               ALenum format, const ALvoid *data,
                               ALsizei offset, ALsizei length)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), length);
    call_void("alDirectCall",
              Py_BuildValue("(sOIiNi)", "alBufferSubDataRawSOFT",
                            static_cast<PyObject*>(context), buffer,
                            static_cast<int>(format), bytes,
                            static_cast<int>(offset)));
}

void alBufferStorageDirectSOFT(ALCcontext *context, ALuint buffer,
                               ALenum format, const ALvoid *data,
                               ALsizei size, ALsizei freq,
                               ALbitfieldSOFT flags)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), size);
    call_void("alDirectCall",
              Py_BuildValue("(sOIiNiI)", "alBufferStorageSOFT",
                            static_cast<PyObject*>(context), buffer,
                            static_cast<int>(format), bytes,
                            static_cast<int>(freq),
                            static_cast<unsigned>(flags)));
}

void alBufferDataStaticDirect(ALCcontext *context, ALuint buffer,
                              ALenum format, ALvoid *data, ALsizei size,
                              ALsizei freq)
{
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(data), size);
    call_void("alDirectCall",
              Py_BuildValue("(sOIiNi)", "alBufferDataStatic",
                            static_cast<PyObject*>(context), buffer,
                            static_cast<int>(format), bytes,
                            static_cast<int>(freq)));
}

void *alMapBufferDirectSOFT(ALCcontext *context, ALuint buffer,
                            ALsizei offset, ALsizei length, ALenum access)
{
    (void)context; /* mapping state lives on the buffer object itself */
    return alMapBufferSOFT(buffer, offset, length, access);
}

void alUnmapBufferDirectSOFT(ALCcontext *context, ALuint buffer)
{
    Gil gil;
    call_void("alDirectCall",
              Py_BuildValue("(sOI)", "alUnmapBufferSOFT",
                            static_cast<PyObject*>(context), buffer));
}

void alFlushMappedBufferDirectSOFT(ALCcontext *context, ALuint buffer,
                                   ALsizei offset, ALsizei length)
{
    Gil gil;
    call_void("alDirectCall",
              Py_BuildValue("(sOIii)", "alFlushMappedBufferSOFT",
                            static_cast<PyObject*>(context), buffer,
                            static_cast<int>(offset),
                            static_cast<int>(length)));
}

void alSourcePlayAtTimevDirectSOFT(ALCcontext *context, ALsizei n,
                                   const ALuint *sources,
                                   ALint64SOFT start_time)
{
    Gil gil;
    for(ALsizei k = 0; k < n; ++k)
        call_void("alDirectCall",
                  Py_BuildValue("(sOIL)", "alSourcePlayAtTimeSOFT",
                                static_cast<PyObject*>(context), sources[k],
                                static_cast<long long>(start_time)));
}

void alEventControlDirectSOFT(ALCcontext *context, ALsizei count,
                              const ALenum *types, ALboolean enable)
{
    Gil gil;
    PyObject *lst = PyList_New(count);
    for(ALsizei i = 0; i < count; ++i)
        PyList_SET_ITEM(lst, i, PyLong_FromLong(types[i]));
    call_void("alDirectCall",
              Py_BuildValue("(sONi)", "alEventControlSOFT",
                            static_cast<PyObject*>(context), lst,
                            enable ? 1 : 0));
}

void alEventCallbackDirectSOFT(ALCcontext *context,
                               void (*callback)(ALenum, ALuint, ALuint,
                                                ALsizei, const ALchar*,
                                                void*),
                               void *userParam)
{
    Gil gil;
    g_cbs.event_fn = callback;
    g_cbs.event_user = userParam;
    PyObject *cb = callback
        ? PyCFunction_New(&g_event_tramp_def, nullptr) : Py_NewRef(Py_None);
    call_void("alDirectCall",
              Py_BuildValue("(sON)", "alEventCallbackSOFT",
                            static_cast<PyObject*>(context), cb));
}

void alDebugMessageCallbackDirectEXT(ALCcontext *context,
                                     void (*callback)(ALenum, ALenum, ALuint,
                                                      ALenum, ALsizei,
                                                      const ALchar*, void*),
                                     void *userParam)
{
    Gil gil;
    g_cbs.debug_fn = callback;
    g_cbs.debug_user = userParam;
    PyObject *cb = callback
        ? PyCFunction_New(&g_debug_tramp_def, nullptr) : Py_NewRef(Py_None);
    call_void("alDirectCall",
              Py_BuildValue("(sON)", "alDebugMessageCallbackEXT",
                            static_cast<PyObject*>(context), cb));
}

void alDebugMessageInsertDirectEXT(ALCcontext *context, ALenum source,
                                   ALenum type, ALuint id, ALenum severity,
                                   ALsizei length, const ALchar *message)
{
    Gil gil;
    call_void("alDirectCall",
              Py_BuildValue("(sOiiIis#)", "alDebugMessageInsertEXT",
                            static_cast<PyObject*>(context),
                            static_cast<int>(source), static_cast<int>(type),
                            id, static_cast<int>(severity), message,
                            static_cast<Py_ssize_t>(
                                length >= 0 ? length
                                            : static_cast<ALsizei>(
                                                strlen(message)))));
}

void alDebugMessageControlDirectEXT(ALCcontext *context, ALenum source,
                                    ALenum type, ALenum severity,
                                    ALsizei count, const ALuint *ids,
                                    ALboolean enable)
{
    Gil gil;
    PyObject *lst = PyList_New(count);
    for(ALsizei i = 0; i < count; ++i)
        PyList_SET_ITEM(lst, i, PyLong_FromUnsignedLong(ids[i]));
    call_void("alDirectCall",
              Py_BuildValue("(sOiiiNi)", "alDebugMessageControlEXT",
                            static_cast<PyObject*>(context),
                            static_cast<int>(source), static_cast<int>(type),
                            static_cast<int>(severity), lst,
                            enable ? 1 : 0));
}

void alPushDebugGroupDirectEXT(ALCcontext *context, ALenum source, ALuint id,
                               ALsizei length, const ALchar *message)
{
    Gil gil;
    call_void("alDirectCall",
              Py_BuildValue("(sOiIs#)", "alPushDebugGroupEXT",
                            static_cast<PyObject*>(context),
                            static_cast<int>(source), id, message,
                            static_cast<Py_ssize_t>(
                                length >= 0 ? length
                                            : static_cast<ALsizei>(
                                                strlen(message)))));
}

void alObjectLabelDirectEXT(ALCcontext *context, ALenum identifier,
                            ALuint name, ALsizei length, const ALchar *label)
{
    Gil gil;
    const char *kind = identifier == 0x19D4 ? "buffer" : "source";
    call_void("alDirectCall",
              Py_BuildValue("(sOsIs#)", "alObjectLabelEXT",
                            static_cast<PyObject*>(context), kind, name,
                            label,
                            static_cast<Py_ssize_t>(
                                length >= 0 ? length
                                            : static_cast<ALsizei>(
                                                strlen(label)))));
}

void alGetObjectLabelDirectEXT(ALCcontext *context, ALenum identifier,
                               ALuint name, ALsizei bufSize, ALsizei *length,
                               ALchar *label)
{
    Gil gil;
    const char *kind = identifier == 0x19D4 ? "buffer" : "source";
    PyObject *r = call("alDirectCall",
                       Py_BuildValue("(sOsI)", "alGetObjectLabelEXT",
                                     static_cast<PyObject*>(context), kind,
                                     name));
    ALsizei n = 0;
    if(r && PyUnicode_Check(r)) {
        const char *s = PyUnicode_AsUTF8(r);
        if(s && label && bufSize > 0) {
            strncpy(label, s, static_cast<size_t>(bufSize) - 1);
            label[bufSize - 1] = 0;
            n = static_cast<ALsizei>(strlen(label));
        }
    }
    if(length) *length = n;
    Py_XDECREF(r);
}

ALuint alGetDebugMessageLogDirectEXT(ALCcontext *context, ALuint count,
                                     ALsizei logBufSize, ALenum *sources,
                                     ALenum *types, ALuint *ids,
                                     ALenum *severities, ALsizei *lengths,
                                     ALchar *logBuf)
{
    (void)context; /* the debug log store is per-context via alDirectCall
                    * for mutations; reads share the current-context log */
    return alGetDebugMessageLogEXT(count, logBufSize, sources, types, ids,
                                   severities, lengths, logBuf);
}

void *alGetPointerDirectEXT(ALCcontext *context, ALenum pname)
{
    (void)context;
    return alGetPointerEXT(pname);
}

void alGetPointervDirectEXT(ALCcontext *context, ALenum pname, void **values)
{
    (void)context;
    alGetPointervEXT(pname, values);
}

/* ==== proc-address resolution ============================================= */

void *alcGetProcAddress(ALCdevice *, const ALCchar *funcname)
{
    if(!funcname) return nullptr;
    /* Resolve inside this very shared object: a client that dlopens the
     * library without RTLD_GLOBAL (ctypes' default) leaves our exports out
     * of the global namespace, so RTLD_DEFAULT alone would miss them. */
    static void *self_handle = [] {
        Dl_info info{};
        if(dladdr(reinterpret_cast<void*>(&alcGetProcAddress), &info)
           && info.dli_fname)
            return dlopen(info.dli_fname, RTLD_NOW | RTLD_NOLOAD);
        return static_cast<void*>(nullptr);
    }();
    if(self_handle)
        if(void *sym = dlsym(self_handle, funcname))
            return sym;
    return dlsym(RTLD_DEFAULT, funcname);
}

void *alGetProcAddress(const ALchar *funcname)
{
    return alcGetProcAddress(nullptr, funcname);
}

void *alGetProcAddressDirect(ALCcontext * /*context*/, const ALchar *funcname)
{
    return alcGetProcAddress(nullptr, funcname);
}

/* ALC_EXT_direct_context (alc/inprogext.h alcGetProcAddress2): same
 * resolution, device-scoped — the Direct variants resolve through here. */
void *alcGetProcAddress2(ALCdevice *device, const ALCchar *funcname)
{
    return alcGetProcAddress(device, funcname);
}

} /* extern "C" */
