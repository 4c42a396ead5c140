"""Scenes and flights repeat from a seed; the atlases are the box-filtered
ripmaps they claim to be."""

import numpy as np
import pytest

from s3dbench import flight, scenegen, spec


@pytest.mark.parametrize("workload", ["default-1080p-frame",
                                      "stress840-1080p-frame"])
def test_scene_repeats_from_a_seed(workload):
    cell = spec.cell(workload)
    a = scenegen.build(cell.config, 2**31 + 11)
    b = scenegen.build(cell.config, 2**31 + 11)
    c = scenegen.build(cell.config, 2**31 + 12)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["vertices"], c["vertices"])
    assert a["vertex_indices"].size // 3 == cell.config["triangles"]
    assert a["textures"].shape == (2, 512, 512)
    assert a["textures"].dtype == np.uint32


@pytest.mark.parametrize("workload", ["default-1080p-frame",
                                      "stress840-4k-batch4"])
def test_flight_repeats_and_the_seed_only_orders_it(workload):
    spec_ = spec.cell(workload).traffic["flight"]
    a, b = flight.walk(spec_), flight.walk(spec_)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (spec_["poses"], 3, 4)
    o1, o2 = flight.order(len(a), 7), flight.order(len(a), 7)
    np.testing.assert_array_equal(o1, o2)
    assert not np.array_equal(o1, flight.order(len(a), 8))
    assert sorted(o1) == list(range(len(a)))
    # Every pose is a rigid camera inside the walk's box.
    box = spec_["box"]
    for m in a:
        np.testing.assert_allclose(m[:, :3] @ m[:, :3].T, np.eye(3), atol=1e-4)
        pos = -m[:, :3].T @ m[:, 3]
        for i, k in enumerate("xyz"):
            assert box[k][0] - 1e-4 <= pos[i] <= box[k][1] + 1e-4


def test_ripmap_levels_are_box_means_of_the_base():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    atlas = scenegen.ripmap_atlas(base)
    for ly, lx in ((256, 256), (64, 128), (8, 2), (1, 1), (256, 1)):
        oy, ox = 512 - 2 * ly if ly < 256 else 0, 512 - 2 * lx if lx < 256 else 0
        box = base.reshape(ly, 256 // ly, lx, 256 // lx, 3).astype(np.float64)
        want = np.round(box.mean(axis=(1, 3))).astype(np.uint32)
        got = atlas[oy:oy + ly, ox:ox + lx]
        np.testing.assert_array_equal(
            got, (want[..., 0] << 16) | (want[..., 1] << 8) | want[..., 2])
