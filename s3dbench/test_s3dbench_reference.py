"""The plain reference on the CPU: it renders, it agrees with the program's
CPU path, and the work it counts does not depend on the program's route."""

import numpy as np
import pytest
import torch

from s3dbench import flight, reference, roofline, scenegen, spec

W, H = 80, 48


def _poses(workload, n=3):
    poses = flight.walk(spec.cell(workload).traffic["flight"])
    return poses[:: len(poses) // n][:n]


def _with_dead_triangles(scene, count):
    """``scene`` and ``count`` more triangles far behind every pose of the
    walk, which no frame draws."""
    out = dict(scene)
    v = np.array([[0.0, 0.0, 50.0, 1.0], [1.0, 0.0, 50.0, 1.0],
                  [0.0, 1.0, 50.0, 1.0]], np.float32)
    nv, na = len(scene["vertices"]), len(scene["normals"])
    out["vertices"] = np.concatenate([scene["vertices"], np.tile(v, (count, 1))])
    out["vertex_indices"] = np.concatenate(
        [scene["vertex_indices"], nv + np.arange(3 * count)])
    out["normals"] = np.concatenate(
        [scene["normals"], np.tile([[0.0, 0.0, 1.0, 0.0]], (3 * count, 1))
         .astype(np.float32)])
    out["attr_vec"] = np.concatenate(
        [scene["attr_vec"], np.full((3 * count, 3), 200.0, np.float32)])
    out["attr_tex"] = np.concatenate([scene["attr_tex"],
                                      np.full(3 * count, -1, np.int64)])
    out["attribute_indices"] = np.concatenate(
        [scene["attribute_indices"], na + np.arange(3 * count)])
    return out


@pytest.mark.parametrize("workload", ["default-1080p-frame",
                                      "default-4k-batch4",
                                      "stress840-1080p-frame"])
def test_reference_renders_a_tiny_frame_as_the_program_does(workload):
    from swift3drenderer_tpu_torch import Renderer, Scene
    from s3dbench.harness import _render_config

    cell = spec.cell(workload)
    sampling = cell.traffic["sampling"]
    scene = scenegen.build(cell.config, 3)
    ref = reference.Reference(scene, cell.config["render"], "cpu")
    program = Renderer(Scene(**scene),
                       config=_render_config(cell.config, sampling),
                       device="cpu")
    for m in _poses(workload):
        pix, depth, work = ref.render(m, W, H, sampling)
        again = ref.render(m, W, H, sampling)
        assert torch.equal(pix, again[0]) and torch.equal(depth, again[1])
        assert pix.shape == (H, W) and pix.dtype == torch.int32
        assert 0 < work.drawn <= W * H and work.slots > 0
        p, d = program.render_device(m, W, H)
        assert reference.mismatch(p, d, pix, depth) <= cell.check["mismatch_max"]


def test_mismatch_counts_differing_pixels():
    pix = torch.full((4, 8), 0x102030, dtype=torch.int32)
    depth = torch.full((4, 8), 0.5)
    assert reference.mismatch(pix, depth, pix, depth) == 0.0
    off = pix.clone()
    off[0, :4] += 2                       # blue off by 2 in 4 of 32 pixels
    assert reference.mismatch(off, depth, pix, depth) == 4 / 32
    off = pix.clone()
    off[0, :4] += 1                       # within the tolerance of 1
    assert reference.mismatch(off, depth, pix, depth) == 0.0
    far = depth.clone()
    far[1, 0] = 0.0                       # covered on one side only
    assert reference.mismatch(pix, far, pix, depth) == 1 / 32


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_work_is_the_same_whatever_the_programs_route(sampling):
    """Dead triangles push the scene past the flat route's 125 slots, so the
    program bins it in segments; the counted work stays the same."""
    from swift3drenderer_tpu_torch.ops.raster import FLAT_MAX_SLOTS

    cell = spec.cell("default-1080p-frame")
    scene = scenegen.build(cell.config, 4)
    padded = _with_dead_triangles(scene, 40)
    assert 2 * len(scene["vertex_indices"]) // 3 <= FLAT_MAX_SLOTS
    assert 2 * len(padded["vertex_indices"]) // 3 > FLAT_MAX_SLOTS
    flat = reference.Reference(scene, cell.config["render"], "cpu")
    seg = reference.Reference(padded, cell.config["render"], "cpu")
    for m in _poses("default-1080p-frame"):
        a = flat.render(m, W, H, sampling)
        b = seg.render(m, W, H, sampling)
        assert torch.equal(a[0], b[0])
        assert (roofline.launch_work([a[2]], W, H, sampling)
                == roofline.launch_work([b[2]], W, H, sampling))


def test_least_time_takes_the_larger_bound():
    card = roofline.peak("NVIDIA H100 80GB HBM3")
    assert roofline.least_seconds(3.35e12, 0, card) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 6.7e13, card) == pytest.approx(1.0)
    assert roofline.peak("some other card") is None
