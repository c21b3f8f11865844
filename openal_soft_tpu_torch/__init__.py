"""openal_soft_tpu_torch — the PyTorch/CUDA port of openal_soft_tpu.

The same renderer as the JAX package, on PyTorch tensors, with the TPU's
Pallas kernels rewritten by hand for NVIDIA Hopper (``csrc/``).  The JAX
package ``openal_soft_tpu`` stays the reference: every module here is tested
against its counterpart there on the same numpy inputs.

The layout mirrors the reference module for module (``ops/``,
``ops/kernels/``, ``core/``, ``effects/``, ``alc/``, ``al/``).  The pure
numpy host modules (``constants``, ``ops.tables``, ``ops.spec``,
``utils.polyphase`` and most of ``core``) are copies of the reference's, so
the port imports nothing of the JAX package.

Idiom: plain functions on tensors; the carried render state (positions,
HRTF history, accumulator tail, effect delay lines) is updated in place
where the JAX package donated its buffers.  The device defaults to the
card — ``LoopbackDevice()`` renders on ``"cuda"`` and raises without one;
the CPU must be asked for with ``device="cpu"`` — and nothing falls back
from the card to the CPU.
"""

__version__ = "0.2.0"
