"""The trace reduction on a hand-made Chrome trace: the window lies between
the marker kernels, and the idle share, busy time and gaps come from it."""

import json

import pytest

from s3dbench import readers, tracing


def _trace(tmp_path):
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [
        x("kernel", "raster_flat_nearest", 0, 50),        # before the window
        x("kernel", spin, 100, 10),                      # opens it at 110
        x("cuda_runtime", "cudaGraphLaunch", 110, 40),
        x("kernel", "elementwise", 130, 30),
        x("kernel", "raster_flat_nearest", 150, 20),
        x("gpu_memcpy", "Memcpy DtoD", 165, 15),
        x("cuda_runtime", "cudaEventSynchronize", 180, 30),
        x("kernel", "elementwise", 205, 10),
        x("kernel", spin, 210, 10),                      # closes it at 210
        x("kernel", "raster_flat_nearest", 300, 50),     # after
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.Trace(str(path))


def test_window_lies_between_the_markers(tmp_path):
    t = _trace(tmp_path)
    assert (t.t0, t.t1) == (110, 210)
    assert abs(t.window_s - 100e-6) < 1e-12
    # busy: [130, 180) and [205, 210)
    assert abs(t.busy_s - 55e-6) < 1e-12
    assert [k[2] for k in t.kernels(True)] == ["raster_flat_nearest"]
    assert [k[2] for k in t.kernels(False)] == ["elementwise", "elementwise"]


def test_idle_share_and_gaps_come_from_the_one_trace(tmp_path):
    class Run:
        trace = _trace(tmp_path)

    assert abs(readers.idle_share(Run) - 45.0) < 1e-9
    gaps = dict(Run.trace.idle_gaps())
    assert abs(gaps["cudaGraphLaunch"] - 20e-6) < 1e-12
    assert abs(gaps["cudaEventSynchronize"] - 25e-6) < 1e-12


def test_a_trace_that_lost_a_marker_is_incomplete(tmp_path):
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": spin, "ts": 0, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 5, "dur": 1},
    ]}))
    with pytest.raises(tracing.Incomplete):
        tracing.Trace(str(path))
