"""A whole run of each cell on the card, at its own size and load, with the
timed path broken underneath: ``correct`` has to come out false for every
fault a cell can have, and true for the sound program. Card only (``-m
cuda``): the program's entry points replay CUDA graphs of CUDA kernels.

The faults, planted in the program's entry points:
- a step that returns its state unchanged: every call returns the frame
  of the first call;
- half of the batch left out: a batch call renders the first half of its
  poses and returns the rest empty (background, nothing covered);
- an answer altered where it is produced: every covered pixel's green
  channel off by 2.
One card, so no exchange between cards to leave out.
"""

import pytest
import torch

from s3dbench import harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
FRAME_CELLS = [c for c in CELLS if spec.cell(c).traffic["client"] == "frame"]
BATCH_CELLS = [c for c in CELLS if spec.cell(c).traffic["client"] == "batch"]

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


@pytest.mark.parametrize("workload", FRAME_CELLS + BATCH_CELLS)
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
