"""Layered ini configuration (alc/alconfig.cpp).

Load order mirrors the reference (alconfig.cpp:433-523): /etc/openal/
alsoft.conf → XDG config dirs → ~/.alsoftrc → $ALSOFT_CONF, later files
overriding earlier ones, with per-device-name [sections] and the same typed
getters.  Keys are the documented alsoftrc.sample names (e.g. ``resampler``,
``hrtf``, ``decoder/hq-mode``).
"""

from __future__ import annotations

import os

_CONFIG: dict[str, str] | None = None


def _parse_ini(path: str, into: dict[str, str]) -> None:
    try:
        with open(path, "r", errors="replace") as fh:
            section = ""
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                if line.startswith("[") and line.endswith("]"):
                    section = line[1:-1].strip().lower()
                    if section == "general":
                        section = ""
                    continue
                if "=" not in line:
                    continue
                key, val = line.split("=", 1)
                key = key.strip().lower()
                val = val.strip().strip('"')
                into[f"{section}/{key}" if section else key] = val
    except OSError:
        pass


def load_config(reload: bool = False) -> dict[str, str]:
    global _CONFIG
    if _CONFIG is not None and not reload:
        return _CONFIG
    conf: dict[str, str] = {}
    _parse_ini("/etc/openal/alsoft.conf", conf)
    xdg_dirs = os.environ.get("XDG_CONFIG_DIRS", "/etc/xdg").split(":")
    for d in reversed(xdg_dirs):
        _parse_ini(os.path.join(d, "alsoft.conf"), conf)
    home = os.path.expanduser("~")
    _parse_ini(os.path.join(home, ".alsoftrc"), conf)
    xdg_home = os.environ.get("XDG_CONFIG_HOME", os.path.join(home, ".config"))
    _parse_ini(os.path.join(xdg_home, "alsoft.conf"), conf)
    if env_path := os.environ.get("ALSOFT_CONF"):
        _parse_ini(env_path, conf)
    _CONFIG = conf
    return conf


def config_value_str(block: str, key: str, default: str | None = None):
    conf = load_config()
    name = f"{block}/{key}".lower() if block else key.lower()
    return conf.get(name, default)


def config_value_int(block: str, key: str, default: int | None = None):
    v = config_value_str(block, key)
    try:
        return int(v, 0) if v is not None else default
    except ValueError:
        return default


def config_value_float(block: str, key: str, default: float | None = None):
    v = config_value_str(block, key)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


def config_value_bool(block: str, key: str, default: bool = False) -> bool:
    v = config_value_str(block, key)
    if v is None:
        return default
    return v.lower() in ("true", "yes", "on", "1")
