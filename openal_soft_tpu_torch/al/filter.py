"""AL filter objects (al/filter.cpp): EFX lowpass/highpass/bandpass gains."""

from __future__ import annotations

FILTER_DEFAULTS = {
    "null": {},
    "lowpass": {"gain": 1.0, "gain_hf": 1.0},
    "highpass": {"gain": 1.0, "gain_lf": 1.0},
    "bandpass": {"gain": 1.0, "gain_hf": 1.0, "gain_lf": 1.0},
}


class Filter:
    def __init__(self, fid: int, filter_type: str = "null") -> None:
        self.id = fid
        self.set_type(filter_type)

    def set_type(self, filter_type: str) -> None:
        if filter_type not in FILTER_DEFAULTS:
            raise ValueError(f"unknown filter type: {filter_type}")
        self.type = filter_type
        self.props = dict(FILTER_DEFAULTS[filter_type])

    def set(self, name: str, value) -> None:
        if name not in self.props:
            raise ValueError(f"{self.type} has no property {name}")
        self.props[name] = value

    def gains(self) -> tuple[float, float, float]:
        """(gain, gain_hf, gain_lf) triple applied to a source path."""
        p = self.props
        return (p.get("gain", 1.0), p.get("gain_hf", 1.0), p.get("gain_lf", 1.0))
