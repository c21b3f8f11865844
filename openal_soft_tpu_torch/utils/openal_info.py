"""Device/extension lister (utils/openal-info.c analog) — smoke tool.

Run: python -m openal_soft_tpu_torch.utils.openal_info [--device cuda|cpu]

Opens its loopback devices on the torch device that ``--device`` names
(``cuda``, the card, by default; it raises without one) and prints that
device with the card's name.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    import torch

    from .. import __version__
    from .._device import resolve_device
    from ..alc.device import LoopbackDevice
    from ..effects import effect_registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    dev_t = resolve_device(args.device)

    print(f"openal_soft_tpu_torch {__version__}")
    name = (torch.cuda.get_device_name(dev_t) if dev_t.type == "cuda"
            else "host CPU")
    print(f"torch {torch.__version__}, device: {dev_t} ({name})")
    dev = LoopbackDevice(frequency=48000, channels="stereo", capacity=16,
                         device=dev_t)
    print(f"default output: {dev.sample_rate} Hz, {dev.fmt_channels.value}, "
          f"render mode {dev.layout.mode.value}")
    print(f"dry bus channels: {dev.n_dry} (ambi order {dev.layout.ambi_order})")
    print("resamplers:", ", ".join(
        n for n in ("point", "linear", "spline", "gaussian", "bsinc12",
                    "fast_bsinc12", "bsinc24", "fast_bsinc24", "bsinc48",
                    "fast_bsinc48")))
    print(f"effects ({len(effect_registry)}):",
          ", ".join(sorted(effect_registry)))
    from ..al import api
    from ..core import hrtf as hrtf_mod

    print("AL extensions:", api.alGetString(api.AL_EXTENSIONS))
    print("ALC extensions:", api.alcGetString(None, api.ALC_EXTENSIONS))
    sets = hrtf_mod.enumerate_hrtf()
    print(f"hrtf data sets ({len(sets)}):",
          ", ".join(n for n, _ in sets) or "(none)")
    hdev = LoopbackDevice(frequency=48000, channels="stereo", hrtf=True,
                          capacity=16, device=dev_t)
    hs = hdev.hrtf_store
    print(f"hrtf: {hs.sample_rate} Hz, irSize {hs.ir_size}, "
          f"{len(hs.field_distances)} field(s), {hs.coeffs.shape[0]} HRIRs")
    from ..al.presets import REVERB_PRESETS
    print(f"reverb presets ({len(REVERB_PRESETS)}):",
          ", ".join(sorted(REVERB_PRESETS)))


if __name__ == "__main__":
    main()
