"""A cell cut to a size the CPU tests can hold: few voices, short calls,
and a compared call early in the window."""

from harness import registry

VOICES = 16


def tiny_cell(name: str, bench: dict | None = None, **kw):
    bench = registry.load_bench() if bench is None else bench
    cell = registry.cell(bench, name, **kw)
    cell.config["device"]["capacity"] = VOICES
    cell.traffic["scene_params"]["voices"] = VOICES
    lp = cell.traffic["loop_params"]
    lp["call_blocks"] = min(lp["call_blocks"], 2)
    cell.traffic["compare_within"] = 2
    cell.traffic["trace_calls"] = 1
    return cell
