/* Embedded-Python runtime shared by the hand-written (alc_shim.cpp) and
 * generated (shim_generated.cpp) halves of libopenal_torch.so. */

#include "shim_runtime.h"

#include <dlfcn.h>
#include <unistd.h>

#include <cstring>
#include <map>
#include <string>

namespace shim {

std::once_flag g_init_once;
PyObject *g_api = nullptr;
static PyThreadState *g_main_tstate = nullptr;

/* The repository root: $OPENAL_TPU_ROOT if set, else the nearest directory
 * above this shared object that holds openal_soft_tpu_torch/__init__.py
 * (the library is built into openal_soft_tpu_torch/_build/<dir>/). */
static std::string package_root()
{
    if(const char *env = getenv("OPENAL_TPU_ROOT"))
        return env;
    Dl_info info;
    if(!dladdr(reinterpret_cast<void*>(&init_python), &info)
       || !info.dli_fname)
        return {};
    std::string dir = info.dli_fname;
    for(auto slash = dir.rfind('/'); slash != std::string::npos && slash > 0;
        slash = dir.rfind('/')) {
        dir.resize(slash);
        const std::string probe = dir + "/openal_soft_tpu_torch/__init__.py";
        if(access(probe.c_str(), R_OK) == 0)
            return dir;
    }
    return {};
}

void init_python()
{
    if(!Py_IsInitialized())
        Py_InitializeEx(0);
    PyGILState_STATE gil = PyGILState_Ensure();
    /* Make the package importable from the root found above. */
    const std::string root = package_root();
    if(!root.empty()) {
        PyObject *sys_path = PySys_GetObject("path");
        PyObject *p = PyUnicode_FromString(root.c_str());
        if(sys_path && p) PyList_Append(sys_path, p);
        Py_XDECREF(p);
    }
    g_api = PyImport_ImportModule("openal_soft_tpu_torch.al.api");
    if(!g_api)
        PyErr_Print();
    PyGILState_Release(gil);
    /* Release the GIL from this (main) thread so later entry points can
     * take it from any thread. */
    if(PyGILState_Check())
        g_main_tstate = PyEval_SaveThread();
}

const char *torch_device()
{
    const char *env = getenv("OPENAL_TORCH_DEVICE");
    return (env && *env) ? env : "cuda";
}

PyObject *call_on_device(const char *name, PyObject *args)
{
    if(!g_api) { Py_XDECREF(args); return nullptr; }
    PyObject *fn = PyObject_GetAttrString(g_api, name);
    PyObject *kw = Py_BuildValue("{s:s}", "device", torch_device());
    PyObject *ret = (fn && kw && args) ? PyObject_Call(fn, args, kw)
                                       : nullptr;
    Py_XDECREF(fn);
    Py_XDECREF(kw);
    Py_XDECREF(args);
    if(!ret) PyErr_Print();
    return ret;
}

PyObject *call(const char *name, PyObject *args)
{
    if(!g_api) { Py_XDECREF(args); return nullptr; }
    PyObject *fn = PyObject_GetAttrString(g_api, name);
    if(!fn) { PyErr_Print(); Py_XDECREF(args); return nullptr; }
    PyObject *ret = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if(!ret) PyErr_Print();
    return ret;
}

long call_long(const char *name, PyObject *args, long dflt)
{
    PyObject *r = call(name, args);
    long v = dflt;
    if(r && PyLong_Check(r)) v = PyLong_AsLong(r);
    else if(r && PyBool_Check(r)) v = (r == Py_True);
    else if(r && PyFloat_Check(r)) v = static_cast<long>(PyFloat_AsDouble(r));
    Py_XDECREF(r);
    return v;
}

double call_double(const char *name, PyObject *args, double dflt)
{
    PyObject *r = call(name, args);
    double v = dflt;
    if(r && PyFloat_Check(r)) v = PyFloat_AsDouble(r);
    else if(r && PyLong_Check(r)) v = static_cast<double>(PyLong_AsLong(r));
    Py_XDECREF(r);
    return v;
}

void call_void(const char *name, PyObject *args)
{
    PyObject *r = call(name, args);
    Py_XDECREF(r);
}

const char *call_string(const char *name, PyObject *args)
{
    /* Interned per distinct value: AL string lifetimes are process-long. */
    static std::map<std::string, std::string> interned;
    static std::mutex mu;
    PyObject *r = call(name, args);
    const char *out = "";
    if(r && PyUnicode_Check(r)) {
        const char *s = PyUnicode_AsUTF8(r);
        if(s) {
            std::lock_guard<std::mutex> lock(mu);
            out = interned.emplace(s, s).first->second.c_str();
        }
    }
    Py_XDECREF(r);
    return out;
}

int vec_len(int param)
{
    switch(param) {
    case 0x1004: case 0x1005: case 0x1006:      /* POSITION/DIRECTION/VELOCITY */
        return 3;
    case 0x100F:                                /* AL_ORIENTATION */
        return 6;
    case 0x2015:                                /* AL_LOOP_POINTS_SOFT */
        return 2;
    case 0x1030:                                /* AL_STEREO_ANGLES */
        return 2;
    case 0x000B: case 0x000E:                   /* reverb pan vectors */
        return 3;
    case 0x20006:                               /* AL_AUXILIARY_SEND_FILTER */
        return 3;
    default:
        return 1;
    }
}

} // namespace shim
