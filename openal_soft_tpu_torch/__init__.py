"""openal_soft_tpu_torch — the PyTorch/CUDA port of openal_soft_tpu.

The same renderer as the JAX package, on PyTorch tensors, with the TPU's
Pallas kernels rewritten by hand for NVIDIA Hopper (``csrc/``).  The JAX
package ``openal_soft_tpu`` stays the reference: every module here is tested
against its counterpart there on the same numpy inputs.

The layout mirrors the reference module for module (``ops/``,
``ops/kernels/``, ``core/``, ``alc/``, ``al/``).  Pure host modules of the
reference (``constants``, ``ops.tables``, ``ops.spec`` and most of ``core``)
import without JAX and are shared, not copied.

Idiom: plain functions on tensors; the carried render state (positions,
HRTF history, accumulator tail) is updated in place where the JAX package
donated its buffers.  The device is explicit — ``LoopbackDevice(...,
device="cpu" | "cuda")`` — and nothing falls back from the card to the CPU.
"""

__version__ = "0.1.0"

from ._shared import share_reference_host_modules

share_reference_host_modules()
