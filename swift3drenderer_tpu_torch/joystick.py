"""Physical game-controller input — the Linux binding for GamepadState.

The reference registers live GameController callbacks for a dual-thumbstick
controller (reference input.swift:62-92: left stick maps to the movement
floats, right stick integrates into the mouse position at 6x scale). This
module binds an actual device on Linux hosts via the kernel joystick API
(``/dev/input/jsN``) and feeds the same :class:`~.camera.GamepadState`
mapping, so the stick->Input semantics are shared with (and tested by) the
virtual-controller path.

The joystick API is chosen over evdev because it needs no libraries and its
event records are trivially parseable: each event is 8 bytes
``struct js_event { u32 time_ms; s16 value; u8 type; u8 number; }`` with
type 0x01 = button, 0x02 = axis (0x80 = synthetic init-state event, OR'd in).
Axis values span [-32767, 32767]. Copy of ``swift3drenderer_tpu.joystick``
over the port's ``GamepadState``.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

from .camera import GamepadState, Input

_EVENT = struct.Struct("<IhBB")  # time_ms, value, type, number

JS_EVENT_BUTTON = 0x01
JS_EVENT_AXIS = 0x02
JS_EVENT_INIT = 0x80

# Default axis numbers under the standard Linux gamepad mapping (xpad and
# most HID pads): left stick = (0, 1), right stick = (3, 4). Kernel y axes
# are down-positive; GameController thumbsticks are up-positive, so y flips.
DEFAULT_AXES = (0, 1, 3, 4)


class JoystickInput(GamepadState):
    """GamepadState fed by a Linux joystick device.

    ``poll()`` drains all pending events non-blockingly (call once per frame),
    then ``update_input`` (inherited) applies the reference's thumbstick
    mapping. ``feed(data)`` consumes raw event bytes directly — the unit-test
    surface, and what ``poll`` uses internally.
    """

    def __init__(self, path: str = "/dev/input/js0",
                 axes: Tuple[int, int, int, int] = DEFAULT_AXES,
                 deadzone: float = 0.08) -> None:
        super().__init__()
        self.axes = axes
        self.deadzone = float(deadzone)
        self._raw = [0.0, 0.0, 0.0, 0.0]  # lx, ly, rx, ry (stick convention)
        self._pending = b""
        self._fd: Optional[int] = None
        if path:
            self._fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)

    # -- event ingestion ------------------------------------------------------
    def feed(self, data: bytes) -> None:
        """Consume raw js_event bytes (possibly a partial trailing record)."""
        data = self._pending + data
        n = len(data) - len(data) % _EVENT.size
        self._pending = data[n:]
        for off in range(0, n, _EVENT.size):
            _, value, etype, number = _EVENT.unpack_from(data, off)
            if not etype & JS_EVENT_AXIS:
                continue  # buttons are unused (the reference binds none)
            try:
                idx = self.axes.index(number)
            except ValueError:
                continue
            v = value / 32767.0
            if abs(v) < self.deadzone:
                v = 0.0
            if idx in (1, 3):
                v = -v  # kernel y is down-positive; thumbstick y is up
            self._raw[idx] = v
        self.set_sticks(left=self._raw[:2], right=self._raw[2:])

    def poll(self) -> None:
        """Drain pending device events (non-blocking); no-op without a device."""
        if self._fd is None:
            return
        while True:
            try:
                data = os.read(self._fd, 64 * _EVENT.size)
            except BlockingIOError:
                return
            except OSError:
                self.close()  # device unplugged: freeze sticks at rest
                self.set_sticks()
                return
            if not data:
                return
            self.feed(data)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "JoystickInput":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_joystick(path: str = "/dev/input/js0") -> Optional[JoystickInput]:
    """Open a joystick if present; None when the device node doesn't exist."""
    if not os.path.exists(path):
        return None
    return JoystickInput(path)


__all__ = ["JoystickInput", "open_joystick", "Input", "DEFAULT_AXES"]
