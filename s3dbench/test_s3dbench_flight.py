"""The walk as the app is driven: ``inputs`` gives each frame's keys, its
accumulated mouse and the camera before it, and ``walk`` is the camera after
each of them. The poses are pinned to the bytes they had before ``inputs``
existed, and the app's own camera, fed the same inputs, flies the same walk.
"""

import hashlib

import numpy as np
import pytest

from s3dbench import flight, harness, spec

# sha256 of the walk's (256, 3, 4) float32 poses as bytes, taken before
# ``walk`` was rebuilt on ``inputs``.
PINNED = {
    "1080p-frame": "3505c53e7e7150628b2ca45fe1f1a1be9f5ac16058e59b9a44643ce5fe52e479",
    "4k-frame": "3505c53e7e7150628b2ca45fe1f1a1be9f5ac16058e59b9a44643ce5fe52e479",
    "4k-batch4": "3505c53e7e7150628b2ca45fe1f1a1be9f5ac16058e59b9a44643ce5fe52e479",
}
APP = spec.cell("default-1080p-app").traffic["flight"]


def _flight(traffic):
    return spec._load(f"{spec.HERE}/traffic/{traffic}.json")["flight"]


@pytest.mark.parametrize("traffic", sorted(PINNED))
def test_walk_keeps_its_poses_bit_for_bit(traffic):
    poses = flight.walk(_flight(traffic))
    assert poses.shape == (256, 3, 4) and poses.dtype == np.float32
    assert hashlib.sha256(poses.tobytes()).hexdigest() == PINNED[traffic]


def test_each_frame_starts_where_the_last_ended():
    frames = flight.inputs(APP)
    assert len(frames) == APP["poses"]
    first = frames[0].before
    assert np.array_equal(first.axes, np.eye(3, dtype=np.float32))
    assert not first.mouse.any()
    for a, b in zip(frames, frames[1:]):
        after = a.after()
        assert np.array_equal(after.position, b.before.position)
        assert np.array_equal(after.axes, b.before.axes)
        assert np.array_equal(after.mouse, b.before.mouse)
    keys = np.array([f.keys for f in frames])
    assert keys.any() and not (keys[:, 0] * keys[:, 1]).any()
    assert set(np.unique(keys)) <= {0.0, APP["run"]}


@pytest.mark.parametrize("start", [0, 97, 255])
def test_the_apps_camera_fed_the_inputs_flies_the_walk(start):
    """From the resume at ``start`` to the wrap, the app's camera holds the
    benchmark camera's state bit for bit. Its matrix agrees in the rotation
    bit for bit and in the translation to 1e-6: there the app sums each
    row's ``-axis . position`` as three dot products and the benchmark as
    one matrix-vector product, which round the last bit apart (one float32
    step of a number under 16 is under 1e-6)."""
    from swift3drenderer_tpu_torch.camera import Camera, Input

    frames, poses = flight.inputs(APP), flight.walk(APP)
    cam = Camera()
    cam.load_pose_state(harness._pose_state(frames[start].before))
    for i in range(start, len(frames)):
        f = frames[i]
        m = cam.update(Input(*f.keys, mouse=(float(f.mouse[0]),
                                             float(f.mouse[1]))))
        after = f.after()
        assert np.array_equal(cam.position, after.position)
        assert np.array_equal(np.stack([cam.axis_x, cam.axis_y, cam.axis_z]),
                              after.axes)
        assert np.array_equal(cam.mouse, after.mouse)
        assert np.array_equal(m[:, :3], poses[i][:, :3])
        assert np.abs(m[:, 3] - poses[i][:, 3]).max() <= 1e-6
