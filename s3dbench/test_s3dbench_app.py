"""The ``app`` client on the CPU at a small size: it drives the app's own
``FrameLoop.step`` through the walk from the seed's start frame, resumes the
app's camera there and at each wrap, keeps copies of the sampled host
buffers with the benchmark's poses, and its check passes the sound program
and fails each of the app's faults (``test_s3dbench_faults.APP_FAULTS``).
The card runs the same at the cell's own size (``-m cuda``)."""

import numpy as np
import pytest
import torch

from s3dbench import flight, harness, reference, scenegen, spec
from s3dbench.test_s3dbench_faults import APP_FAULTS

WORKLOAD = "default-1080p-app"
SEED = 2**31 + 4321
W, H = 96, 56
CALLS = 300                 # past the walk's 256 frames: one wrap at least


def _client():
    from swift3drenderer_tpu_torch import Scene
    from swift3drenderer_tpu_torch.app import FrameLoop

    cell = spec.cell(WORKLOAD)
    tr = cell.traffic
    scene = scenegen.build(cell.config, SEED)
    poses = flight.walk(tr["flight"])
    loop = FrameLoop(Scene(**scene), W, H,
                     config=harness._render_config(cell.config, tr["sampling"]),
                     device="cpu")
    start = int(flight.order(len(poses), SEED)[0])
    return cell, scene, harness.AppClient(loop, flight.inputs(tr["flight"]),
                                          poses, start,
                                          cell.check["sample_calls"])


def _readings():
    torch.set_num_threads(1)
    cell, scene, client = _client()
    sample = harness.Reservoir(cell.check["sample_calls"], SEED, client.own)
    win = client.run(calls=CALLS, keep=sample)
    assert win.calls == win.frames == CALLS
    ref = reference.Reference(scene, cell.config["render"], "cpu")
    out = []
    for ms, pix, depth in sample.items:
        assert depth is None and ms.shape == (1, 3, 4)
        assert pix.shape == (H, W) and pix.dtype == torch.int32
        rp, rd, _ = ref.render(ms[0], W, H, cell.traffic["sampling"])
        out.append(harness.compare(cell.check, pix, depth, rp, rd,
                                   ref.background))
    return cell, out


def test_app_traffic_names_the_app_client():
    tr = spec.cell(WORKLOAD).traffic
    assert tr["client"] == "app"
    assert (tr["width"], tr["height"], tr["sampling"]) == (1920, 1080, "nearest")
    # The traced window is the whole walk, so every seed traces its frames.
    assert (tr["batch"], tr["in_flight"]) == (1, 1)
    assert tr["trace_calls"] == tr["flight"]["poses"] == 256
    frame = spec._load(f"{spec.HERE}/traffic/1080p-frame.json")
    assert tr["flight"] == frame["flight"]


def test_traced_poses_are_the_whole_walk():
    _, _, client = _client()
    n = len(client.poses)
    traced = np.stack([client.poses_of(k)[0] for k in range(n)])
    assert sorted(map(bytes, traced)) == sorted(map(bytes, client.poses))


def test_client_resumes_at_the_start_and_at_each_wrap(monkeypatch):
    from swift3drenderer_tpu_torch.camera import Camera

    _, _, client = _client()
    resumed = []
    real = Camera.load_pose_state

    def load(self, state):
        resumed.append(state)
        real(self, state)

    monkeypatch.setattr(Camera, "load_pose_state", load)
    n = len(client.inputs)
    client.run(calls=n + 2)
    starts = [0] + [k for k in range(1, n + 2) if (client.start + k) % n == 0]
    assert resumed == [client.states[(client.start + k) % n] for k in starts]
    assert np.array_equal(client.poses_of(0)[0], client.poses[client.start])
    assert client.loop.frame_index == n + 2


def test_sampled_buffers_are_copies():
    cell, _, client = _client()
    sample = harness.Reservoir(4, SEED, client.own)
    client.run(calls=4, keep=sample)
    kept = [p.clone() for _, p, _ in sample.items]
    client.run(calls=4)       # the loop writes its two buffers again
    for (_, p, _), k in zip(sample.items, kept):
        assert torch.equal(p, k)


def test_sound_app_is_correct():
    cell, readings = _readings()
    assert len(readings) == cell.check["sample_calls"]
    assert max(readings) <= cell.check["mismatch_max"]


@pytest.mark.parametrize("fault", sorted(APP_FAULTS))
def test_app_fault_fails_the_check(fault, monkeypatch):
    APP_FAULTS[fault](monkeypatch)
    cell, readings = _readings()
    assert max(readings) > cell.check["mismatch_max"]
