"""The port's camera and input state (swift3drenderer_tpu_torch.camera: the
pose checkpoint, ``KeyboardState`` and ``GamepadState``) held against the
JAX package's, on a scripted sequence of keys, mouse moves and sticks.

Both are numpy on the host, so every ``Input`` float and every view matrix
must be equal exactly.
"""

import dataclasses
import json

import numpy as np
import torch

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu import camera as jcam

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

# (kind, arguments): key events, mouse deltas (counted only while the
# cursor is captured), capture toggles and stick positions, one camera
# update after each.
SCRIPT = [
    ("mouse", (3.0, 1.0)),                       # not captured: ignored
    ("key", ("w", True)),
    ("capture", ()),
    ("mouse", (2.5, -0.75)),
    ("key", ("Shift", True)),
    ("mouse", (-4.0, 2.0)),
    ("key", ("a", True)),
    ("key", ("w", False)),
    ("key", ("d", True)),
    ("mouse", (0.125, 7.0)),
    ("key", ("shift", False)),
    ("key", ("s", True)),
    ("capture", ()),
    ("mouse", (9.0, 9.0)),                       # released: ignored
    ("key", ("a", False)),
    ("key", ("escape", True)),
]
STICKS = [((0.0, 0.0), (0.0, 0.0)), ((0.5, 0.0), (0.0, 0.0)),
          ((0.0, -1.0), (0.25, 0.0)), ((-0.3, 0.7), (-0.5, 0.125)),
          ((0.0, 0.0), (1.0, -1.0)), ((1.0, 1.0), (0.0, 0.0))]


def drive_keyboard(mod):
    kb, cam, inp = mod.KeyboardState(), mod.Camera(), mod.Input()
    trace = []
    for step, (kind, args) in enumerate(SCRIPT):
        if kind == "key":
            kb.key_event(*args)
        elif kind == "mouse":
            kb.mouse_delta(*args)
        else:
            kb.toggle_capture()
        inp = kb.update_input(inp)
        m = cam.update(inp, force_update=(step == 0)).copy()
        trace.append((dataclasses.astuple(inp), m, kb.quit_requested,
                      kb.mouse_captured, kb.mouse_accum.copy()))
    return trace, cam


def drive_gamepad(mod):
    pad, cam, inp = mod.GamepadState(), mod.Camera(), mod.Input()
    trace = []
    for step, (left, right) in enumerate(STICKS):
        pad.set_sticks(left=left, right=right)
        inp = pad.update_input(inp)
        m = cam.update(inp, force_update=(step == 0)).copy()
        trace.append((dataclasses.astuple(inp), m, pad.mouse_accum.copy()))
    return trace, cam


def assert_traces_equal(ours, ref):
    assert len(ours) == len(ref)
    for step, (a, b) in enumerate(zip(ours, ref)):
        assert a[0] == b[0], step                # the Input floats
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y, err_msg=f"step {step}")


def test_keyboard_state_matches_jax():
    (ours, cam), (ref, _) = drive_keyboard(port), drive_keyboard(jcam)
    assert_traces_equal(ours, ref)
    assert ours[-1][2]                           # escape asked to quit
    assert not np.array_equal(cam.matrix, np.eye(3, 4, dtype=np.float32))


def test_gamepad_state_matches_jax():
    (ours, cam), (ref, _) = drive_gamepad(port), drive_gamepad(jcam)
    assert_traces_equal(ours, ref)
    assert ours[-1][0][4] != (0.0, 0.0)          # the right stick turned


def test_pose_state_round_trips_and_matches_jax():
    (_, cam), (_, ref) = drive_keyboard(port), drive_keyboard(jcam)
    state = cam.pose_state()
    assert state == ref.pose_state()
    # Serializable: through JSON into a fresh camera, the same pose.
    back = port.Camera()
    back.load_pose_state(json.loads(json.dumps(state)))
    np.testing.assert_array_equal(back.matrix, cam.matrix)
    for field in ("position", "axis_x", "axis_y", "axis_z", "mouse"):
        np.testing.assert_array_equal(getattr(back, field), getattr(cam, field))
        assert getattr(back, field).dtype == np.float32
    # A restored camera flies on as the original does.
    inp = port.Input(up=1.0, mouse=(float(cam.mouse[0]) + 6.0, 0.0))
    np.testing.assert_array_equal(back.update(inp), cam.update(inp))
    assert port.KeyboardState is port.camera.KeyboardState
    assert port.GamepadState is port.camera.GamepadState
