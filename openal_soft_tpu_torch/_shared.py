"""Share the reference's host modules without loading its JAX render path.

The port uses the reference's pure host modules (``core.voice``,
``core.context``, ``core.hrtf``, ...).  A few of their functions read the
configuration at run time with ``from ..alc import config`` — creating a
``Voice`` does — and importing the package ``openal_soft_tpu.alc`` runs its
``__init__``, which imports the JAX render path (``alc/context.py`` ->
``ops/filters.py`` -> ``jax``).

So, unless the package is already loaded, ``openal_soft_tpu.alc`` is
registered from its own spec without running ``__init__``.  Its submodules
(``config``, ``context``, ``device``, ...) import as usual, and the two
names ``__init__`` exports, ``Context`` and ``LoopbackDevice``, resolve
lazily on first access, so the JAX package keeps working in the same
process; it only loads its render path when something asks for it.  The
port itself never does: a port render leaves ``jax`` unimported
(tests/test_torch_imports.py).
"""

from __future__ import annotations

import importlib
import importlib.util
import sys

_ALC = "openal_soft_tpu.alc"
_EXPORTS = {"Context": "context", "LoopbackDevice": "device"}


def _lazy_export(name: str):
    """``__init__``'s exports and, as after a real ``__init__``, the
    submodules as attributes — each imported on first access."""
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{_ALC}.{_EXPORTS[name]}"),
                       name)
    if not name.startswith("__") and importlib.util.find_spec(
            f"{_ALC}.{name}") is not None:
        return importlib.import_module(f"{_ALC}.{name}")
    raise AttributeError(f"module {_ALC!r} has no attribute {name!r}")


def share_reference_host_modules() -> None:
    if _ALC in sys.modules:
        return
    spec = importlib.util.find_spec(_ALC)
    pkg = importlib.util.module_from_spec(spec)   # __init__ not executed
    pkg.__getattr__ = _lazy_export
    pkg.__all__ = list(_EXPORTS)
    sys.modules[_ALC] = pkg
