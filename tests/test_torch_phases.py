"""The raster kernel's timing forms in the port (``phases="vis"`` and
``"shade"``), held against the JAX package's on the CPU.

The same seeded poses go through ``build_setup`` in both packages; the JAX
side rasterizes with ``rasterize_pallas(..., phases=p, interpret=True)`` (the
Pallas kernel in interpret mode, as tests/test_pallas.py runs it, at its
default 64-row tiles: one tile row at 128x64), the port with ``rasterize(...,
phases=p)`` on the CPU, which takes the kernels' plain versions. The default
scene (102 slots) takes the flat route in both packages, stress_scene(objects=8)
(198 slots) the segmented one. The ``"full"`` form is not called here: in
interpret mode it takes about 25 s a frame, and the full forms have tests of
their own.

Bounds: ``"vis"`` winning slots identical (the port's int32 plane viewed as
uint32 equals the JAX plane, -1 as 0xFFFFFFFF) and, tracked, the gid planes
identical; ``"shade"`` pixel mismatch < 5e-4 at tol 1 (XLA's CPU multiply-add
contraction may move a shaded channel by one step); depth rtol 1e-4 where
drawn, drawn sets equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.models import SCENES, stress_scene
from swift3drenderer_tpu.ops import raster_pallas as jr
from swift3drenderer_tpu.renderer import build_setup as jax_build_setup
from swift3drenderer_tpu.renderer import scene_to_device
import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.renderer import build_setup as port_build_setup

from conftest import pixel_mismatch_fraction
from test_torch_ids import port_arrays, random_poses

# One intra-op thread a process (the suite runs one pytest worker per core).
torch.set_num_threads(1)

W, H = 128, 64
BG = DEFAULT_CONFIG.background_packed


def _setups(scene, seed):
    """The scene's setup tables at one of test_fuzz's random poses, from
    each package's front-end: (JAX setup, JAX textures, port setup, port
    textures)."""
    jdev = scene_to_device(scene)
    m = random_poses(seed, 1)[0]
    jsetup = jax.jit(partial(jax_build_setup, width=W, height=H,
                             config=DEFAULT_CONFIG))(jdev, jnp.asarray(m))
    pdev = port_arrays(jdev)
    psetup = port_build_setup(pdev, torch.from_numpy(m), width=W, height=H,
                              config=port.DEFAULT_CONFIG)
    return jsetup, jdev["textures"], psetup, pdev["textures"]


@pytest.fixture(scope="module")
def scenes():
    """The default scene (flat route) and stress_scene(objects=8) (segmented
    route), each at a random pose that draws most of the frame."""
    return {"flat": _setups(SCENES["default"](seed=0), 5002),
            "segmented": _setups(stress_scene(seed=0, objects=8), 5004)}


@partial(jax.jit, static_argnames=("phases", "sampling"))
def _jax_form(setup, textures, phases, sampling):
    return jr.rasterize_pallas(setup, textures, width=W, height=H,
                               background=BG, interpret=True,
                               sampling=sampling, phases=phases)


@partial(jax.jit, static_argnames=("phases",))
def _jax_tracked(setup, textures, gids, phases):
    """The Pallas kernel's tracking form in one pass (``_rasterize_chunk``
    with ``gids``): (pixels, depth, gids) (1, H, W)."""
    return jr._rasterize_chunk(
        jax.tree.map(lambda a: a[None], setup), textures, width=W, height=H,
        background=BG, tile_h=64, tile_w=128, y_offset=0, interpret=True,
        sampling="nearest", phases=phases, gids=gids)


def _port_form(psetup, ptex, phases, sampling="nearest", gids=None):
    return tr.rasterize(psetup, ptex, width=W, height=H, background=BG,
                        sampling=sampling, gids=gids, phases=phases)


def _assert_depth(depth, ref_depth):
    drawn = depth > 0
    np.testing.assert_array_equal(drawn, ref_depth > 0)
    np.testing.assert_allclose(depth[drawn], ref_depth[drawn], rtol=1e-4)
    assert drawn.mean() > 0.3


def test_route_of_each_scene(scenes):
    """The default scene lies under the port's flat limit and the JAX flat
    condition (S + 3 <= 128); stress(objects=8) above both."""
    assert scenes["flat"][2]["live"].shape[0] <= tr.FLAT_MAX_SLOTS
    assert scenes["flat"][2]["live"].shape[0] + 3 <= 128
    assert scenes["segmented"][2]["live"].shape[0] > 128


@pytest.mark.parametrize("route", ["flat", "segmented"])
def test_vis_form_matches_jax(scenes, route):
    """``phases="vis"``: each pixel's winning slot (-1 where nothing
    covers) and its 1/z, equal to the Pallas kernel's."""
    jsetup, jtex, psetup, ptex = scenes[route]
    ref_pix, ref_depth = map(np.asarray, _jax_form(jsetup, jtex, "vis",
                                                   "nearest"))
    pix, depth = _port_form(psetup, ptex, "vis")
    assert pix.dtype == torch.int32
    np.testing.assert_array_equal(pix.numpy().view(np.uint32), ref_pix)
    _assert_depth(depth.numpy(), ref_depth)
    slots = pix.numpy()
    assert slots.min() == -1 or (depth.numpy() > 0).all()
    assert slots.max() < psetup["live"].shape[0]


@pytest.mark.parametrize("route,sampling", [("flat", "nearest"),
                                            ("segmented", "nearest"),
                                            ("flat", "bilinear")])
def test_shade_form_matches_jax(scenes, route, sampling):
    """``phases="shade"``: the frame before the texel fetch, flat-coloured
    winners packed, textured winners at the background."""
    jsetup, jtex, psetup, ptex = scenes[route]
    ref_pix, ref_depth = map(np.asarray, _jax_form(jsetup, jtex, "shade",
                                                   sampling))
    pix, depth = _port_form(psetup, ptex, "shade", sampling)
    pix = pix.numpy().view(np.uint32)
    assert pixel_mismatch_fraction(pix, ref_pix, tol=1) < 5e-4
    _assert_depth(depth.numpy(), ref_depth)
    # Textured winners are left at the background: some pixel is drawn and
    # still holds it.
    assert ((depth.numpy() > 0) & (pix == BG)).any()


def test_vis_form_tracked_gid_plane_matches_jax(scenes):
    """The tracked ``"vis"`` form on the segmented route: the kernel
    wrapper's gid plane (-1 where nothing covers) identical to the Pallas
    kernel's tracking form, and the winning slots too; ``rasterize(gids=)``
    gives the same gids where drawn and NO_GID elsewhere."""
    jsetup, jtex, psetup, ptex = scenes["segmented"]
    s = psetup["live"].shape[0]
    gids = np.arange(s, dtype=np.int32) * 2 + 1000
    ref_pix, ref_depth, ref_gid = (np.asarray(a)[0] for a in _jax_tracked(
        jsetup, jtex, jnp.asarray(gids), "vis"))
    trf, tri = tr.pack_setup_tables(psetup, torch.from_numpy(gids))
    pix, depth, gid = tr.raster_segmented_nearest(
        *tr.bin_segments(psetup, width=W, height=H), trf, tri,
        tr.pack_slot_records(psetup), ptex, width=W, height=H, background=BG,
        track_ids=True, phases="vis")
    np.testing.assert_array_equal(pix.numpy().view(np.uint32), ref_pix)
    np.testing.assert_array_equal(gid.numpy(), ref_gid)
    _assert_depth(depth.numpy(), ref_depth)
    pix2, depth2, gid2 = _port_form(psetup, ptex, "vis",
                                    gids=torch.from_numpy(gids))
    assert torch.equal(pix2, pix) and torch.equal(depth2, depth)
    assert torch.equal(gid2, torch.where(depth > 0, gid, tr.NO_GID))


def test_plain_forms_of_the_kernels(scenes):
    """Every wrapper takes ``phases`` on the CPU (its plain version): vis
    and shade of the flat and segmented wrappers, both samplings, agree
    with ``rasterize``'s and leave the launch counters alone; the shade
    form is the full frame wherever the winner is untextured; an unknown
    form raises."""
    for route, (_, _, psetup, ptex) in scenes.items():
        trf, tri = tr.pack_setup_tables(psetup)
        if route == "flat":
            ids, counts = tr.bin_triangles(psetup, width=W, height=H,
                                           tile_h=tr.TILE_H, tile_w=tr.TILE_W)
            args = (counts, ids, trf, tri)
        else:
            args = (*tr.bin_segments(psetup, width=W, height=H), trf, tri,
                    tr.pack_slot_records(psetup))
        for sampling in tr.SAMPLINGS:
            wrapper = getattr(tr, f"raster_{route}_{sampling}")
            before = (wrapper.launches, wrapper.launches_ids,
                      wrapper.launches_vis, wrapper.launches_shade)
            full = wrapper(*args, ptex, width=W, height=H, background=BG)
            for phases in ("vis", "shade"):
                got = wrapper(*args, ptex, width=W, height=H, background=BG,
                              phases=phases)
                want = _port_form(psetup, ptex, phases, sampling)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert torch.equal(got[1], full[1])
            untextured = (got[0] != BG) | (full[0] == BG)
            assert torch.equal(got[0][untextured], full[0][untextured])
            assert (wrapper.launches, wrapper.launches_ids,
                    wrapper.launches_vis, wrapper.launches_shade) == before
            with pytest.raises(ValueError, match="phases"):
                wrapper(*args, ptex, width=W, height=H, background=BG,
                        phases="fetch")
    with pytest.raises(ValueError, match="phases"):
        _port_form(scenes["flat"][2], scenes["flat"][3], "full ")
