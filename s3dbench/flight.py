"""Camera flights: the app's inputs walked from a seed, turned into poses.

The camera arithmetic is the benchmark's own copy of the upstream's fly-around
camera (render/render.swift:113-135, ``camera.Camera.update``): WASD
translation along the camera's x and z axes at ``speed`` units a frame, and
the mouse's motion turned into a rotation by the shortest-arc quaternion
from the old view axis to ``normalize(dx * x + dy * y + 100 / rotation_speed
* z)``; the pose is the (3, 4) matrix ``[axis | -axis . position]``.

A traffic file's ``flight`` key fixes the walk: how many poses, the seed of
the walk, how long a goal is held, the mouse's most a frame, and the box and
view angles the goals lie in, so that the scene stays in view. The
walk is the same for every run; the run's seed only orders it
(``order``), so that every seed renders the same set of frames. ``inputs``
gives the walk as the app is driven: each frame's keys and accumulated
mouse, and the camera before it; an app flies it in sequence, from a frame
the seed draws, and the poses are the camera after each frame (``walk``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

SPEED = 0.1               # RenderConfig.speed: units a frame
ROTATION_SPEED = 0.3      # RenderConfig.rotation_speed

def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.float32(np.linalg.norm(v))


def _quat_from_to(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w = 1.0 + float(np.dot(a, b))
    xyz = np.cross(a, b)
    q = np.array([xyz[0], xyz[1], xyz[2], w], np.float32)
    return (q / np.linalg.norm(q)).astype(np.float32)


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    t = 2.0 * np.cross(q[:3], v)
    return (v + q[3] * t + np.cross(q[:3], t)).astype(np.float32)


class Camera:
    """Position, axes and the last mouse position, in float32."""

    def __init__(self) -> None:
        self.position = np.zeros(3, np.float32)
        self.axes = np.eye(3, dtype=np.float32)       # rows: x, y, z
        self.mouse = np.zeros(2, np.float32)

    def copy(self) -> "Camera":
        c = Camera()
        c.position, c.axes, c.mouse = (self.position.copy(), self.axes.copy(),
                                       self.mouse.copy())
        return c

    def update(self, up, down, left, right, mouse) -> None:
        """One frame of input (render.swift:113-135)."""
        x, y, z = self.axes
        if up or down or left or right:
            self.position = self.position + np.float32(SPEED) * (
                (right - left) * x + (down - up) * z).astype(np.float32)
        mouse = np.asarray(mouse, np.float32)
        if not np.array_equal(mouse, self.mouse):
            nz = _normalize((self.mouse[0] - mouse[0]) * x
                            + (self.mouse[1] - mouse[1]) * y
                            + np.float32(100.0 / ROTATION_SPEED) * z)
            q = _quat_from_to(z, nz)
            self.axes = np.stack([_normalize(_quat_rotate(q, x)),
                                  _normalize(_quat_rotate(q, y)),
                                  nz.astype(np.float32)])
            self.mouse = mouse

    def matrix(self) -> np.ndarray:
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = self.axes
        m[:, 3] = -(self.axes @ self.position)
        return m

    def view_angles(self):
        """(yaw, pitch) in degrees of the view direction, -z axis."""
        d = -self.axes[2]
        return (math.degrees(math.atan2(d[0], -d[2])),
                math.degrees(math.asin(max(-1.0, min(1.0, float(d[1]))))))


def _inside(pos: np.ndarray, box: dict) -> bool:
    return all(lo <= pos[i] <= hi
               for i, (lo, hi) in enumerate((box["x"], box["y"], box["z"])))


@dataclasses.dataclass(frozen=True)
class Frame:
    """One frame of the walk: the keys pressed (up, down, left, right), the
    accumulated mouse position the app is given, and the camera before it."""

    keys: Tuple[float, float, float, float]
    mouse: np.ndarray
    before: Camera

    def after(self) -> Camera:
        """The camera once this frame's input is applied."""
        cam = self.before.copy()
        cam.update(*self.keys, self.mouse)
        return cam


def inputs(spec: dict) -> List[Frame]:
    """The spec["poses"] frames of the seeded walk ``spec``: the app's input
    for each and the camera before it.

    The walk starts at the box's centre, looking along -z. It is a run of
    held goals, each lasting a number of frames drawn
    from ``hold``: a point of the box and a view (yaw within ``yaw_deg``,
    pitch within ``pitch_deg``). Each frame presses the keys that move the
    camera toward the point (WASD, at most one of each pair) and moves the
    mouse toward the view by at most ``mouse`` units on each axis; a step
    that would leave the box is taken without the keys."""
    rng = np.random.default_rng(spec["seed"])
    box = spec["box"]
    cam = Camera()
    cam.position = np.array([0.5 * sum(box[k]) for k in "xyz"], np.float32)
    frames: List[Frame] = []
    hold = 0
    per_deg = 100.0 / ROTATION_SPEED * math.tan(math.radians(1.0))
    lim = np.asarray(spec["mouse"], np.float64)
    while len(frames) < spec["poses"]:
        if hold == 0:
            hold = int(rng.integers(spec["hold"][0], spec["hold"][1] + 1))
            goal = np.array([rng.uniform(*box[k]) for k in "xyz"], np.float32)
            view = np.array([rng.uniform(-spec["yaw_deg"], spec["yaw_deg"]),
                             rng.uniform(*spec["pitch_deg"])])
        to = goal - cam.position
        ahead = float(np.dot(to, -cam.axes[2]))
        side = float(np.dot(to, cam.axes[0]))
        run = float(spec["run"])     # 2: the shift key held (input.swift:78)
        keys = tuple(run * k for k in (ahead > 0.3, ahead < -0.3,
                                       side < -0.3, side > 0.3))
        turn = np.clip(0.3 * per_deg * (view - np.array(cam.view_angles())),
                       -lim, lim).astype(np.float32)
        frame = Frame(keys, cam.mouse + turn, cam)
        nxt = frame.after()
        if not _inside(nxt.position, box):
            frame = Frame((0.0, 0.0, 0.0, 0.0), frame.mouse, cam)
            nxt = frame.after()
        frames.append(frame)
        cam = nxt
        hold -= 1
    return frames


def walk(spec: dict) -> np.ndarray:
    """(spec["poses"], 3, 4) float32 poses of the seeded walk ``spec``: the
    camera after each frame of ``inputs``."""
    return np.stack([f.after().matrix() for f in inputs(spec)]).astype(
        np.float32)


def order(n: int, seed: int) -> np.ndarray:
    """The run's order of n poses: a permutation drawn from ``seed``."""
    return np.random.default_rng(seed).permutation(n)
