"""The reference's example programs on the port, one module each.

    python -m openal_soft_tpu_torch.examples.<name> [--device cuda|cpu] ...

Every example renders on the card (``--device cuda``, the default; it
raises without one) unless ``--device cpu`` asks for the CPU.
"""

DEVICE_HELP = "torch device: cuda (the card, default) or cpu"
