"""Data-file search paths (core/helpers.cpp:316-350 SearchDataFiles).

Resolution order matches the reference: an absolute subdir searches only
itself; otherwise XDG_DATA_HOME (or ~/.local/share), then each
XDG_DATA_DIRS entry (default /usr/local/share:/usr/share), each with
``openal/<subdir>`` appended, plus ALSOFT_LOCAL_PATH (or the current
directory) for the no-subdir form — extended here with the package's own
shipped ``data/<subdir>`` as the final fallback so the framework works out
of the box.
"""

from __future__ import annotations

import os

_PKG_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def data_dirs(subdir: str) -> list[str]:
    """Directories to search for ``openal/<subdir>`` data files."""
    if os.path.isabs(subdir):
        return [subdir]
    dirs: list[str] = []
    if env := os.environ.get("ALSOFT_LOCAL_PATH"):
        dirs.append(env)
    xdg_home = os.environ.get("XDG_DATA_HOME",
                              os.path.expanduser("~/.local/share"))
    dirs.append(os.path.join(xdg_home, "openal", subdir))
    for d in os.environ.get("XDG_DATA_DIRS",
                            "/usr/local/share:/usr/share").split(":"):
        if d:
            dirs.append(os.path.join(d, "openal", subdir))
    dirs.append(os.path.join(_PKG_DATA, subdir))
    return dirs


def search_data_files(ext: str, subdir: str) -> list[str]:
    """All files with the extension across the search dirs, sorted within
    each directory (DirectorySearch, core/helpers.cpp:280-310)."""
    out: list[str] = []
    for d in data_dirs(subdir):
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        out += [os.path.join(d, n) for n in names if n.lower().endswith(ext)]
    return out


def find_data_file(name: str, ext: str, subdir: str) -> str | None:
    """Resolve a (possibly relative) data-file name: absolute/existing
    paths pass through; otherwise the first search-dir hit wins."""
    if os.path.isabs(name) or os.path.exists(name):
        return name
    if not name.lower().endswith(ext):
        name += ext
    for d in data_dirs(subdir):
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None
