"""AL_EXT_debug: debug message log, severity filtering, groups, labels.

Host re-realization of al/debug.cpp: a per-context debug state with

  * a message callback OR a bounded message log (64 entries,
    al/debug.h:17-19: MaxDebugLoggedMessages=64, MaxDebugMessageLength=1024,
    MaxDebugGroupDepth=64),
  * (source, type, severity/id) enable filtering scoped to the current
    debug group (alDebugMessageControlEXT semantics: id filters take
    precedence over severity filters, debug.cpp:236-320),
  * a debug-group stack whose push/pop emit notification messages,
  * object labels for sources/buffers/effects/filters/aux slots.

Port of openal_soft_tpu/al/debug.py, unchanged.
"""

from __future__ import annotations

import dataclasses
import threading

# Enum values from AL/alext.h (AL_EXT_debug).
AL_DEBUG_OUTPUT_EXT = 0x19B2
AL_DEBUG_CALLBACK_FUNCTION_EXT = 0x19B3
AL_DEBUG_CALLBACK_USER_PARAM_EXT = 0x19B4
AL_DEBUG_SOURCE_API_EXT = 0x19B5
AL_DEBUG_SOURCE_AUDIO_SYSTEM_EXT = 0x19B6
AL_DEBUG_SOURCE_THIRD_PARTY_EXT = 0x19B7
AL_DEBUG_SOURCE_APPLICATION_EXT = 0x19B8
AL_DEBUG_SOURCE_OTHER_EXT = 0x19B9
AL_DEBUG_TYPE_ERROR_EXT = 0x19BA
AL_DEBUG_TYPE_DEPRECATED_BEHAVIOR_EXT = 0x19BB
AL_DEBUG_TYPE_UNDEFINED_BEHAVIOR_EXT = 0x19BC
AL_DEBUG_TYPE_PORTABILITY_EXT = 0x19BD
AL_DEBUG_TYPE_PERFORMANCE_EXT = 0x19BE
AL_DEBUG_TYPE_MARKER_EXT = 0x19BF
AL_DEBUG_TYPE_PUSH_GROUP_EXT = 0x19C0
AL_DEBUG_TYPE_POP_GROUP_EXT = 0x19C1
AL_DEBUG_TYPE_OTHER_EXT = 0x19C2
AL_DEBUG_SEVERITY_HIGH_EXT = 0x19C3
AL_DEBUG_SEVERITY_MEDIUM_EXT = 0x19C4
AL_DEBUG_SEVERITY_LOW_EXT = 0x19C5
AL_DEBUG_SEVERITY_NOTIFICATION_EXT = 0x19C6
AL_DEBUG_LOGGED_MESSAGES_EXT = 0x19C7
AL_DEBUG_NEXT_LOGGED_MESSAGE_LENGTH_EXT = 0x19C8
AL_DONT_CARE_EXT = 0x0002
AL_STACK_OVERFLOW_EXT = 0x19CD
AL_STACK_UNDERFLOW_EXT = 0x19CE

MAX_DEBUG_LOGGED_MESSAGES = 64      # al/debug.h:17
MAX_DEBUG_MESSAGE_LENGTH = 1024     # al/debug.h:18
MAX_DEBUG_GROUP_DEPTH = 64          # al/debug.h:19
MAX_OBJECT_LABEL_LENGTH = 1024

SOURCES = (AL_DEBUG_SOURCE_API_EXT, AL_DEBUG_SOURCE_AUDIO_SYSTEM_EXT,
           AL_DEBUG_SOURCE_THIRD_PARTY_EXT, AL_DEBUG_SOURCE_APPLICATION_EXT,
           AL_DEBUG_SOURCE_OTHER_EXT)
TYPES = (AL_DEBUG_TYPE_ERROR_EXT, AL_DEBUG_TYPE_DEPRECATED_BEHAVIOR_EXT,
         AL_DEBUG_TYPE_UNDEFINED_BEHAVIOR_EXT, AL_DEBUG_TYPE_PORTABILITY_EXT,
         AL_DEBUG_TYPE_PERFORMANCE_EXT, AL_DEBUG_TYPE_MARKER_EXT,
         AL_DEBUG_TYPE_PUSH_GROUP_EXT, AL_DEBUG_TYPE_POP_GROUP_EXT,
         AL_DEBUG_TYPE_OTHER_EXT)
SEVERITIES = (AL_DEBUG_SEVERITY_HIGH_EXT, AL_DEBUG_SEVERITY_MEDIUM_EXT,
              AL_DEBUG_SEVERITY_LOW_EXT, AL_DEBUG_SEVERITY_NOTIFICATION_EXT)


@dataclasses.dataclass
class _Group:
    source: int
    gid: int
    message: str
    # Filter state is copied from the parent group on push
    # (alPushDebugGroupEXT, debug.cpp:340-383).
    disabled_sev: set = dataclasses.field(default_factory=set)
    id_filter: dict = dataclasses.field(default_factory=dict)


class DebugState:
    """Per-context AL_EXT_debug state (al::Context debug members)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.callback = None
        self.user_param = None
        self.enabled = True                  # AL_DEBUG_OUTPUT_EXT
        self.log: list[tuple] = []           # (source, type, id, sev, msg)
        base = _Group(AL_DEBUG_SOURCE_OTHER_EXT, 0, "")
        # Default: LOW severity disabled (debug.cpp Context ctor disables
        # low-severity messages by default).
        base.disabled_sev = {(s, t, AL_DEBUG_SEVERITY_LOW_EXT)
                             for s in SOURCES for t in TYPES}
        self.groups: list[_Group] = [base]
        self.labels: dict[tuple[str, int], str] = {}

    # --- filtering ---

    def _filtered(self, source, mtype, mid, severity) -> bool:
        g = self.groups[-1]
        if (source, mtype, mid) in g.id_filter:
            return not g.id_filter[(source, mtype, mid)]
        return (source, mtype, severity) in g.disabled_sev

    # --- message flow ---

    def message(self, source, mtype, mid, severity, msg: str) -> None:
        """sendDebugMessage (al/debug.cpp:200-235)."""
        with self.lock:
            if not self.enabled or self._filtered(source, mtype, mid, severity):
                return
            msg = msg[:MAX_DEBUG_MESSAGE_LENGTH - 1]
            cb = self.callback
            if cb is not None:
                up = self.user_param
            elif len(self.log) < MAX_DEBUG_LOGGED_MESSAGES:
                self.log.append((source, mtype, mid, severity, msg))
                return
            else:
                return
        cb(source, mtype, mid, severity, msg, up)

    def control(self, source, mtype, severity, ids, enable: bool) -> None:
        """alDebugMessageControlEXT (debug.cpp:236-320).

        ``ids`` non-empty requires specific source+type and DONT_CARE
        severity; otherwise severity filters apply to the cartesian set of
        the DONT_CARE axes."""
        g = self.groups[-1]
        if ids:
            if (source == AL_DONT_CARE_EXT or mtype == AL_DONT_CARE_EXT
                    or severity != AL_DONT_CARE_EXT):
                raise ValueError(
                    "ID filters need explicit source/type and DONT_CARE "
                    "severity")
            for i in ids:
                g.id_filter[(source, mtype, i)] = enable
            return
        srcs = SOURCES if source == AL_DONT_CARE_EXT else (source,)
        typs = TYPES if mtype == AL_DONT_CARE_EXT else (mtype,)
        sevs = SEVERITIES if severity == AL_DONT_CARE_EXT else (severity,)
        for s in srcs:
            for t in typs:
                for sv in sevs:
                    if enable:
                        g.disabled_sev.discard((s, t, sv))
                    else:
                        g.disabled_sev.add((s, t, sv))

    # --- groups ---

    def push_group(self, source, gid, message) -> None:
        if len(self.groups) >= MAX_DEBUG_GROUP_DEPTH:
            raise OverflowError("max debug group depth reached")
        parent = self.groups[-1]
        g = _Group(source, gid, message,
                   disabled_sev=set(parent.disabled_sev),
                   id_filter=dict(parent.id_filter))
        self.groups.append(g)
        self.message(source, AL_DEBUG_TYPE_PUSH_GROUP_EXT, gid,
                     AL_DEBUG_SEVERITY_NOTIFICATION_EXT, message)

    def pop_group(self) -> None:
        if len(self.groups) <= 1:
            raise IndexError("attempting to pop the default debug group")
        g = self.groups.pop()
        self.message(g.source, AL_DEBUG_TYPE_POP_GROUP_EXT, g.gid,
                     AL_DEBUG_SEVERITY_NOTIFICATION_EXT, g.message)

    # --- log retrieval ---

    def get_log(self, count: int) -> list[tuple]:
        """alGetDebugMessageLogEXT: pop up to ``count`` entries."""
        with self.lock:
            out, self.log = self.log[:count], self.log[count:]
            return out

    # --- labels ---

    def set_label(self, kind: str, oid: int, label: str | None) -> None:
        if label:
            if len(label) >= MAX_OBJECT_LABEL_LENGTH:
                raise ValueError("label too long")
            self.labels[(kind, oid)] = label
        else:
            self.labels.pop((kind, oid), None)

    def get_label(self, kind: str, oid: int) -> str:
        return self.labels.get((kind, oid), "")


def get_debug(ctx) -> DebugState:
    """The context's debug state, created on first use."""
    st = getattr(ctx, "_debug_state", None)
    if st is None:
        st = ctx._debug_state = DebugState()
    return st
