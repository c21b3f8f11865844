"""AL error codes + typed exception (al/error.cpp, AL/al.h).

The object layer raises ALError (or plain KeyError for unknown ids); the
C-style entry points in al/api.py catch these and record the code on the
current context, where alGetError() pops it — the reference's first-error-
sticks model (error.cpp:59-98).
"""

from __future__ import annotations

AL_NO_ERROR = 0
AL_INVALID_NAME = 0xA001
AL_INVALID_ENUM = 0xA002
AL_INVALID_VALUE = 0xA003
AL_INVALID_OPERATION = 0xA004
AL_OUT_OF_MEMORY = 0xA005

_NAMES = {
    AL_NO_ERROR: "AL_NO_ERROR",
    AL_INVALID_NAME: "AL_INVALID_NAME",
    AL_INVALID_ENUM: "AL_INVALID_ENUM",
    AL_INVALID_VALUE: "AL_INVALID_VALUE",
    AL_INVALID_OPERATION: "AL_INVALID_OPERATION",
    AL_OUT_OF_MEMORY: "AL_OUT_OF_MEMORY",
}


class ALError(Exception):
    """An AL-level error with its enum code."""

    def __init__(self, code: int, message: str = "") -> None:
        self.code = code
        super().__init__(f"{_NAMES.get(code, hex(code))}: {message}")


def invalid_name(msg: str = "invalid object id") -> ALError:
    return ALError(AL_INVALID_NAME, msg)


def invalid_enum(msg: str = "invalid enum value") -> ALError:
    return ALError(AL_INVALID_ENUM, msg)


def invalid_value(msg: str = "invalid value") -> ALError:
    return ALError(AL_INVALID_VALUE, msg)


def invalid_operation(msg: str = "invalid operation") -> ALError:
    return ALError(AL_INVALID_OPERATION, msg)
