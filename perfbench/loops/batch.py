"""Loop ``batch``: one caller renders fixed-size chunks back to back, as an
offline or server renderer does, each call ``alcRenderSamplesSOFT`` for
``call_blocks`` 1024-frame blocks, ending in the host copy it returns.

End to end: ``realtime_x``, the audio of every call the window completed
over the window's wall time."""

from __future__ import annotations

from harness import reduce

BLOCK = 1024


class Loop:
    def __init__(self, scene: dict, params: dict, seed: int) -> None:
        self.al, self.dev = scene["al"], scene["dev"]
        self.rate = scene["rate"]
        self.blocks = int(params["call_blocks"])
        self.frames = self.blocks * BLOCK

    def call(self, k: int, spans):
        with spans("render_call"):
            return self.al.alcRenderSamplesSOFT(self.dev, self.frames)

    def end_to_end(self, calls: list) -> dict:
        return {"realtime_x": reduce.realtime_x(calls, self.frames,
                                                self.rate)}
