/* Shared embedded-Python runtime for the libopenal_torch C ABI shim.
 *
 * One embedded interpreter per process, initialized lazily on the first
 * device open; every entry point grabs the GIL via PyGILState and forwards
 * to openal_soft_tpu_torch.al.api.  Split from alc_shim.cpp so the generated
 * export surface (shim_generated.cpp, emitted by gen_shim.py) shares the
 * same interpreter and helpers.
 */
#ifndef OPENAL_TORCH_SHIM_RUNTIME_H
#define OPENAL_TORCH_SHIM_RUNTIME_H

/* "s#" / "y#" Py_BuildValue formats take Py_ssize_t lengths only with this
 * defined (mandatory since Python 3.10; without it every such call fails
 * at runtime with a confusing missing-arguments TypeError). */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <mutex>

namespace shim {

extern std::once_flag g_init_once;
extern PyObject *g_api;            /* openal_soft_tpu_torch.al.api module */

void init_python();

struct Gil {
    PyGILState_STATE st;
    Gil() { st = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(st); }
};

/* Ensure the interpreter is up (safe to call from any entry point). */
inline void ensure_init() { std::call_once(g_init_once, init_python); }

/* Call api.<name>(*args); steals args; returns new ref or nullptr. */
PyObject *call(const char *name, PyObject *args);

/* Call api.<name>(*args, device=<torch device>) for the entry points that
 * open a render device; steals args. */
PyObject *call_on_device(const char *name, PyObject *args);

/* The torch device the C ABI renders on: $OPENAL_TORCH_DEVICE, else
 * "cuda" (the card; an open then fails without one). */
const char *torch_device();

long call_long(const char *name, PyObject *args, long dflt = 0);
double call_double(const char *name, PyObject *args, double dflt = 0.0);
void call_void(const char *name, PyObject *args);

/* Copy a returned str into a process-lifetime interned buffer (AL string
 * returns must stay valid after the call). */
const char *call_string(const char *name, PyObject *args);

/* Vector-parameter lengths for the fv/iv entry points (the C caller hands
 * a bare pointer; the AL param determines how many elements it holds). */
int vec_len(int param);

} // namespace shim

#endif /* OPENAL_TORCH_SHIM_RUNTIME_H */
