"""Camera and input state machine.

Reproduces the reference's fly-around camera exactly (reference
render/render.swift:113-135): WASD translation along the camera's x/z axes, mouse-delta
rotation via the shortest-arc quaternion from the old view axis to the new one, and a
4x3 row-major view matrix ``[axis | -axis . position]``.

This runs on the host in float32 NumPy — it is ~30 flops per frame; only the resulting
(3, 4) matrix crosses to the device. Copy of ``swift3drenderer_tpu.camera``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig


@dataclasses.dataclass
class Input:
    """The host->renderer input ABI (reference render-cpp/render.hpp:15-21).

    ``mouse`` is the *accumulated* mouse position, not a per-frame delta: the input
    layer integrates deltas while the cursor is captured (reference input.swift:41-45)
    and the camera differences it against the last-seen value.
    """

    up: float = 0.0
    down: float = 0.0
    left: float = 0.0
    right: float = 0.0
    mouse: tuple = (0.0, 0.0)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.float32(np.linalg.norm(v))


def quat_from_to(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Shortest-arc unit quaternion rotating unit vector ``a`` onto ``b``
    (the semantics of simd_quatf(from:to:), used at render.swift:124)."""
    w = 1.0 + float(np.dot(a, b))
    xyz = np.cross(a, b)
    q = np.array([xyz[0], xyz[1], xyz[2], w], dtype=np.float32)
    n = np.linalg.norm(q)
    if n == 0.0:  # a == -b: 180-degree rotation, axis ill-defined
        axis = np.cross(a, np.array([1.0, 0.0, 0.0], np.float32))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0], np.float32))
        axis = _normalize(axis)
        return np.array([axis[0], axis[1], axis[2], 0.0], dtype=np.float32)
    return (q / n).astype(np.float32)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector ``v`` by unit quaternion ``q = (x, y, z, w)``."""
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    return (v + q[3] * t + np.cross(qv, t)).astype(np.float32)


class Camera:
    """Mutable camera pose + view-matrix cache (reference State, render.swift:4-9)."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG) -> None:
        self.config = config
        self.position = np.zeros(3, dtype=np.float32)
        self.axis_x = np.array([1.0, 0.0, 0.0], dtype=np.float32)
        self.axis_y = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        self.axis_z = np.array([0.0, 0.0, 1.0], dtype=np.float32)
        self.mouse = np.zeros(2, dtype=np.float32)
        self.matrix = np.eye(3, 4, dtype=np.float32)
        self._rebuild()

    def _rebuild(self) -> None:
        # render.swift:131-133 — rows [axis | -dot(axis, position)]
        m = np.zeros((3, 4), dtype=np.float32)
        for row, ax in enumerate((self.axis_x, self.axis_y, self.axis_z)):
            m[row, :3] = ax
            m[row, 3] = -np.dot(ax, self.position)
        self.matrix = m

    def update(self, inp: Input, force_update: bool = False) -> np.ndarray:
        """Apply one frame of input; returns the (3, 4) view matrix
        (reference updateCamera, render.swift:113-135)."""
        changed = False
        if inp.left > 0 or inp.right > 0 or inp.up > 0 or inp.down > 0:
            changed = True
            self.position = self.position + np.float32(self.config.speed) * (
                (inp.right - inp.left) * self.axis_x
                + (inp.down - inp.up) * self.axis_z
            ).astype(np.float32)
        mouse = np.asarray(inp.mouse, dtype=np.float32)
        if not np.array_equal(mouse, self.mouse):
            changed = True
            z = _normalize(
                (self.mouse[0] - mouse[0]) * self.axis_x
                + (self.mouse[1] - mouse[1]) * self.axis_y
                + np.float32(100.0 / self.config.rotation_speed) * self.axis_z
            )
            q = quat_from_to(self.axis_z, z)
            self.axis_x = _normalize(quat_rotate(q, self.axis_x))
            self.axis_y = _normalize(quat_rotate(q, self.axis_y))
            self.axis_z = z.astype(np.float32)
            self.mouse = mouse
        if changed or force_update:
            self._rebuild()
        return self.matrix

    def pose_state(self) -> dict:
        """Serializable pose (for checkpoint/resume — absent in the reference,
        SURVEY.md section 5)."""
        return {
            "position": self.position.tolist(),
            "axis_x": self.axis_x.tolist(),
            "axis_y": self.axis_y.tolist(),
            "axis_z": self.axis_z.tolist(),
            "mouse": self.mouse.tolist(),
        }

    def load_pose_state(self, state: dict) -> None:
        self.position = np.asarray(state["position"], dtype=np.float32)
        self.axis_x = np.asarray(state["axis_x"], dtype=np.float32)
        self.axis_y = np.asarray(state["axis_y"], dtype=np.float32)
        self.axis_z = np.asarray(state["axis_z"], dtype=np.float32)
        self.mouse = np.asarray(state["mouse"], dtype=np.float32)
        self._rebuild()


class KeyboardState:
    """Maps key state to the Input floats like the reference input layer
    (reference input.swift:75-93): WASD with shift doubling speed; the mouse value
    only updates while captured."""

    def __init__(self) -> None:
        self.keys: set = set()
        self.mouse_captured = False
        self.mouse_accum = np.zeros(2, dtype=np.float32)
        self.quit_requested = False

    def key_event(self, key: str, pressed: bool) -> None:
        key = key.lower()
        if pressed:
            self.keys.add(key)
        else:
            self.keys.discard(key)
        if key == "escape" and pressed:
            self.quit_requested = True

    def mouse_delta(self, dx: float, dy: float) -> None:
        if self.mouse_captured:
            self.mouse_accum += np.array([dx, dy], dtype=np.float32)

    def toggle_capture(self) -> None:
        self.mouse_captured = not self.mouse_captured

    def update_input(self, inp: Input) -> Input:
        speed = 2.0 if ("shift" in self.keys) else 1.0  # input.swift:78
        inp.left = speed if "a" in self.keys else 0.0
        inp.right = speed if "d" in self.keys else 0.0
        inp.up = speed if "w" in self.keys else 0.0
        inp.down = speed if "s" in self.keys else 0.0
        if self.mouse_captured:
            inp.mouse = (float(self.mouse_accum[0]), float(self.mouse_accum[1]))
        return inp


class GamepadState:
    """Dual-thumbstick input mapping — the reference's iOS virtual controller
    path (reference input.swift:62-92): the left stick maps to the movement
    floats (left/right from x, up/down from y) and the right stick integrates
    into the mouse position at 6x scale."""

    MOUSE_SCALE = 6.0  # input.swift:91

    def __init__(self) -> None:
        self.left_stick = np.zeros(2, dtype=np.float32)
        self.right_stick = np.zeros(2, dtype=np.float32)
        self.mouse_accum = np.zeros(2, dtype=np.float32)

    def set_sticks(self, left=(0.0, 0.0), right=(0.0, 0.0)) -> None:
        self.left_stick = np.asarray(left, dtype=np.float32)
        self.right_stick = np.asarray(right, dtype=np.float32)

    def update_input(self, inp: Input) -> Input:
        # input.swift:87-91 — note left/up are the negated stick axes.
        inp.left = float(-self.left_stick[0])
        inp.right = float(self.left_stick[0])
        inp.up = float(self.left_stick[1])
        inp.down = float(-self.left_stick[1])
        self.mouse_accum += np.float32(self.MOUSE_SCALE) * self.right_stick
        inp.mouse = (float(self.mouse_accum[0]), float(self.mouse_accum[1]))
        return inp
