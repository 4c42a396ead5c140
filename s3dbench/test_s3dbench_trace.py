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


def _copies_trace(tmp_path):
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}

    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    dtoh = "Memcpy DtoH (Device -> Pageable)"
    events = [
        x("gpu_memcpy", dtoh, 0, 50, bytes=999),          # before the window
        x("kernel", spin, 100, 10),                      # opens it at 110
        x("kernel", "raster_flat_nearest", 110, 20),
        x("gpu_memcpy", dtoh, 130, 40, bytes=8294400),
        x("gpu_memcpy", dtoh, 170, 30, bytes=8294400),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 200, 5, bytes=64),
        x("kernel", spin, 210, 10),                      # closes it at 210
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.Trace(str(path))


def test_readback_readers_sum_the_device_to_host_copies(tmp_path):
    class Run:
        trace = _copies_trace(tmp_path)
        traced_frames = 2

    assert [c[3] for c in Run.trace.device_to_host()] == [8294400, 8294400]
    assert readers.readback_bytes(Run) == 8294400
    assert abs(readers.readback_device_us(Run) - 35.0) < 1e-9
    # The existing readings do not see the copies' bytes.
    assert abs(Run.trace.busy_s - 95e-6) < 1e-12


def test_readback_readers_read_nothing_without_copies_or_a_trace(tmp_path):
    class Untraced:
        trace = None
        traced_frames = 64

    class NoCopies:
        trace = _trace(tmp_path)
        traced_frames = 1

    for run in (Untraced, NoCopies):
        assert readers.readback_bytes(run) is None
        assert readers.readback_device_us(run) is None
