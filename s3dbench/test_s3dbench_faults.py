"""A whole run of each cell on the card, at its own size and load, with the
timed path broken underneath: ``correct`` has to come out false for every
fault a cell can have, and true for the sound program. Card only (``-m
cuda``): the program's entry points replay CUDA graphs of CUDA kernels.

The faults, planted in the program's entry points:
- a step that returns its state unchanged: every call returns the frame
  of the first call; in the app, ``FrameLoop.step`` returns the other half
  of its double buffer, the frame before;
- half of the batch left out: a batch call renders the first half of its
  poses and returns the rest empty (background, nothing covered);
- an answer altered where it is produced: every covered pixel's green
  channel off by 2 (in the app, in ``Renderer.render``'s host frame);
- an input lost (the app): after each resume of its camera, the first
  frame whose mouse moves 4 units or more on an axis loses that move; the
  camera takes the new mouse position as seen without turning, so it looks
  the wrong way until the next resume.
One card, so no exchange between cards to leave out.
"""

import numpy as np
import pytest
import torch

from s3dbench import harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]] + spec.held()
FRAME_CELLS = [c for c in CELLS if spec.cell(c).traffic["client"] == "frame"]
BATCH_CELLS = [c for c in CELLS if spec.cell(c).traffic["client"] == "batch"]
APP_CELLS = [c for c in CELLS if spec.cell(c).traffic["client"] == "app"]

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs the "
                    "program's CUDA kernels")


def _run(workload, seed=2**31 + 5):
    return harness.run_cell(workload, seed, 1.0, False).line


def _stale(monkeypatch, name):
    from swift3drenderer_tpu_torch import Renderer

    real = getattr(Renderer, name)

    def stale(self, m, w, h):
        if not hasattr(self, "_first"):
            self._first = real(self, m, w, h)
        return self._first

    monkeypatch.setattr(Renderer, name, stale)


def _altered(monkeypatch, name):
    from swift3drenderer_tpu_torch import Renderer

    real = getattr(Renderer, name)

    def altered(self, m, w, h):
        pix, depth = real(self, m, w, h)
        return pix + (depth > 0).to(pix.dtype) * 0x000200, depth

    monkeypatch.setattr(Renderer, name, altered)


def _half_batch(monkeypatch):
    from swift3drenderer_tpu_torch import Renderer

    real = Renderer.render_batch

    def half(self, ms, w, h):
        pix, depth = real(self, ms[: len(ms) // 2], w, h)
        rest = len(ms) - len(pix)
        return (torch.cat([pix, torch.full((rest, h, w),
                                           self.config.background_packed,
                                           dtype=pix.dtype,
                                           device=pix.device)]),
                torch.cat([depth, depth.new_zeros((rest, h, w))]))

    monkeypatch.setattr(Renderer, "render_batch", half)


def stale_buffer(monkeypatch):
    """``FrameLoop.step`` returns the other half of its double buffer."""
    from swift3drenderer_tpu_torch.app import FrameLoop

    real = FrameLoop.step

    def stale(self, inp=None):
        fresh = real(self, inp)
        other = self._buffers[self._buffer_index]
        return fresh if other is None else other

    monkeypatch.setattr(FrameLoop, "step", stale)


def altered_host_frame(monkeypatch):
    """``Renderer.render``'s covered pixels with green off by 2."""
    from swift3drenderer_tpu_torch import Renderer

    real = Renderer.render

    def altered(self, m, w, h, bucketed=False):
        pix, depth = real(self, m, w, h, bucketed)
        return pix + (depth > 0).astype(pix.dtype) * np.uint32(0x200), depth

    monkeypatch.setattr(Renderer, "render", altered)


def mouse_dropped(monkeypatch):
    """After each resume, the camera loses the first mouse move of 4 units
    or more (module docstring)."""
    from swift3drenderer_tpu_torch.camera import Camera

    real_update, real_load = Camera.update, Camera.load_pose_state

    def load(self, state):
        real_load(self, state)
        self._drop = True

    def update(self, inp, force_update=False):
        mouse = np.asarray(inp.mouse, np.float32)
        if getattr(self, "_drop", False) and np.abs(mouse - self.mouse).max() >= 4:
            self.mouse, self._drop = mouse, False
        return real_update(self, inp, force_update)

    monkeypatch.setattr(Camera, "load_pose_state", load)
    monkeypatch.setattr(Camera, "update", update)


APP_FAULTS = {"stale_buffer": stale_buffer,
              "altered_host_frame": altered_host_frame,
              "mouse_dropped": mouse_dropped}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_program_is_correct(workload):
    line = _run(workload)
    assert line["correct"] is True
    assert line["check"]["mismatch_max"]["value"] <= \
        line["check"]["mismatch_max"]["limit"]


@pytest.mark.parametrize("workload", FRAME_CELLS + BATCH_CELLS)
def test_state_returned_unchanged_is_not_correct(workload, monkeypatch):
    _stale(monkeypatch, "render_device" if workload in FRAME_CELLS
           else "render_batch")
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", BATCH_CELLS)
def test_half_of_the_batch_left_out_is_not_correct(workload, monkeypatch):
    _half_batch(monkeypatch)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", FRAME_CELLS + BATCH_CELLS)
def test_answer_altered_where_produced_is_not_correct(workload, monkeypatch):
    _altered(monkeypatch, "render_device" if workload in FRAME_CELLS
             else "render_batch")
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("fault", sorted(APP_FAULTS))
@pytest.mark.parametrize("workload", APP_CELLS)
def test_app_fault_is_not_correct(workload, fault, monkeypatch):
    APP_FAULTS[fault](monkeypatch)
    line = _run(workload)
    assert line["correct"] is False
    assert line["check"]["frames_compared"]["value"] == \
        spec.cell(workload).check["sample_calls"]
