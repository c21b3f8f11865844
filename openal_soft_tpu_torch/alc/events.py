"""ALC_SOFT_system_events: device add/remove/default-change notifications.

Host analog of alc/events.cpp: one process-wide callback + enabled-type
set behind a mutex; backends report device arrival/loss through
``emit_event``.  Without an OS audio session manager there is no hot-plug
stream to subscribe to, so support is reported per event type the way the
reference's backends do (alcEventIsSupportedSOFT): the ALSA/null backends
report add/remove support (emitted on open/disconnect), default-change is
unsupported (our default routing is config-static).

Port of openal_soft_tpu/alc/events.py, unchanged.
"""

from __future__ import annotations

import threading

ALC_EVENT_TYPE_DEFAULT_DEVICE_CHANGED_SOFT = 0x19D6
ALC_EVENT_TYPE_DEVICE_ADDED_SOFT = 0x19D7
ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT = 0x19D8
ALC_EVENT_SUPPORTED_SOFT = 0x19D9
ALC_EVENT_NOT_SUPPORTED_SOFT = 0x19DA
ALC_PLAYBACK_DEVICE_SOFT = 0x19D4
ALC_CAPTURE_DEVICE_SOFT = 0x19D5

_EVENT_TYPES = (ALC_EVENT_TYPE_DEFAULT_DEVICE_CHANGED_SOFT,
                ALC_EVENT_TYPE_DEVICE_ADDED_SOFT,
                ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT)

_lock = threading.Lock()
_callback = None
_user_ptr = None
_enabled: set[int] = set()


def alcEventControlSOFT(event_types, enable: bool) -> bool:
    """Enable/disable delivery of the given event types."""
    for t in event_types:
        if t not in _EVENT_TYPES:
            return False
    with _lock:
        if enable:
            _enabled.update(event_types)
        else:
            _enabled.difference_update(event_types)
    return True


def alcEventCallbackSOFT(callback, user_ptr=None) -> None:
    """callback(event_type, device_type, device, message, user_ptr)."""
    global _callback, _user_ptr
    with _lock:
        _callback = callback
        _user_ptr = user_ptr


def alcEventIsSupportedSOFT(event_type: int, device_type: int) -> int:
    """Which events this implementation can actually deliver."""
    if event_type in (ALC_EVENT_TYPE_DEVICE_ADDED_SOFT,
                      ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT) \
            and device_type == ALC_PLAYBACK_DEVICE_SOFT:
        return ALC_EVENT_SUPPORTED_SOFT
    return ALC_EVENT_NOT_SUPPORTED_SOFT


def emit_event(event_type: int, device_type: int, device, message: str) -> None:
    """alc::Event (alc/events.cpp): deliver if enabled + callback set."""
    with _lock:
        cb = _callback
        up = _user_ptr
        deliver = cb is not None and event_type in _enabled
    if deliver:
        try:
            cb(event_type, device_type, device, message, up)
        except Exception:   # noqa: BLE001 — app callback must not kill us
            pass
