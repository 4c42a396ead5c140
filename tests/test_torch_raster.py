"""The port's rasterizer (swift3drenderer_tpu_torch.ops.raster) held against the
JAX package's flat Pallas path, on CPU.

The JAX kernel runs in interpret mode, as tests/test_pallas.py runs it; the
port runs the plain PyTorch version of ``raster_flat_nearest`` (a CPU tensor
never reaches the CUDA kernel). Both rasterize the same setup table, made by
the JAX front-end, so only the rasterizer can differ. Bounds: winners equal on
>= 99.95 % of pixels, pixel mismatch < 5e-4 at tol 1 (the bound
test_pallas_matches_xla keeps between the JAX package's own two paths), depth
rtol 1e-4 where both are drawn.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.ops import raster_pallas as jr
from swift3drenderer_tpu.ops import texture as jtexture
from swift3drenderer_tpu.renderer import build_setup, scene_to_device
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.ops import texture as ttexture

from conftest import pixel_mismatch_fraction

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

W, H = 320, 240
BG = DEFAULT_CONFIG.background_packed
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_torch(setup):
    return {k: torch.from_numpy(np.array(v)) for k, v in setup.items()}


@pytest.fixture(scope="module")
def default_frames():
    """The default scene's JAX setup table under the identity camera (the pose
    of test_pallas_matches_xla) and two steps of a turning flight."""
    dev = scene_to_device(SCENES["default"](seed=0))
    cam = Camera()
    frames = []
    for step in range(3):
        m = cam.update(Input(up=float(step > 0), mouse=(8.0 * step, 0.0)),
                       force_update=(step == 0))
        frames.append(build_setup(dev, jnp.asarray(m), width=W, height=H,
                                  config=DEFAULT_CONFIG))
    return dev, frames


def test_pack_setup_tables_matches_jax(default_frames):
    _, frames = default_frames
    for setup in frames:
        fj, ij = jr.pack_setup_tables(setup)
        ft, it = tr.pack_setup_tables(to_torch(setup))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_bin_triangles_matches_jax_at_port_tile(default_frames):
    _, frames = default_frames
    for setup in frames:
        ids_j, counts_j = jr.bin_triangles(setup, width=W, height=H,
                                           tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        ids_t, counts_t = tr.bin_triangles(to_torch(setup), width=W, height=H,
                                           tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
        assert counts_t.max() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_triangles_matches_jax_on_random_bboxes(seed):
    # Synthetic bboxes (as tests/test_pallas.py's partition test), on a ragged
    # tile grid: 100 x 50 px is not a multiple of the 32 x 8 tile.
    rng = np.random.default_rng(seed)
    s, w, h = 60, 100, 50
    xmin = rng.integers(0, w, s)
    ymin = rng.integers(0, h, s)
    arrays = dict(xmin=xmin, xmax=xmin + rng.integers(0, w, s),
                  ymin=ymin, ymax=ymin + rng.integers(0, h, s))
    arrays = {k: v.astype(np.int32) for k, v in arrays.items()}
    live = rng.random(s) < 0.8
    sj = {k: jnp.asarray(v) for k, v in arrays.items()}
    sj["live"] = jnp.asarray(live)
    st = {k: torch.from_numpy(v) for k, v in arrays.items()}
    st["live"] = torch.from_numpy(live)
    ids_j, counts_j = jr.bin_triangles(sj, width=w, height=h,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
    ids_t, counts_t = tr.bin_triangles(st, width=w, height=h,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))


@pytest.fixture(scope="module")
def both_rasters(default_frames):
    """setup -> (JAX (pixels, depth, winners), port's plain (pixels, depth,
    winners)) as numpy. The JAX side is ``_rasterize_chunk`` in interpret
    mode with winner ids tracked, jitted once for every pose."""
    dev, frames = default_frames
    s = frames[0]["live"].shape[0]
    textures = torch.from_numpy(np.array(dev["textures"]).view(np.int32))
    chunk = jax.jit(lambda setup: jr._rasterize_chunk(
        jax.tree.map(lambda a: a[None], setup), dev["textures"],
        width=W, height=H, background=BG, tile_h=64, tile_w=128,
        y_offset=0, interpret=True, sampling="nearest",
        gids=jnp.arange(s, dtype=jnp.int32)))

    def run(setup):
        ref = tuple(np.asarray(a[0]) for a in chunk(setup))
        st = to_torch(setup)
        ids, counts = tr.bin_triangles(st, width=W, height=H,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        trf, tri = tr.pack_setup_tables(st)
        best, win = tr.visibility_plain(counts, ids, trf, tri, width=W,
                                        height=H)
        pix = tr.shade_plain(best, win, trf, tri, textures, background=BG)
        return ref, (pix.numpy().view(np.uint32), best.numpy(), win.numpy())

    return run


def test_plain_raster_matches_pallas_chunk(default_frames, both_rasters):
    """Pixels, depth and winner ids of the plain version against the Pallas
    kernel on the same setup tables."""
    _, frames = default_frames
    for setup in frames:
        (pj, dj, gj), (pix, depth, win) = both_rasters(setup)
        assert (win == gj).mean() >= 0.9995
        assert pixel_mismatch_fraction(pix, pj, tol=1) < 5e-4
        both = (dj > 0) & (depth > 0)
        np.testing.assert_allclose(depth[both], dj[both], rtol=1e-4)
        assert (gj >= 0).mean() > 0.2        # the frame is not empty


def texel_coordinates_f64(trf, best, win, yy, xx):
    """fmod(uv, 1) * L per axis, (2, n), at pixels (yy, xx): the port's
    perspective-correct uv and ripmap level recomputed in float64 from the
    same f32 tables and depths, so free of either side's rounding order."""
    f = trf.numpy().astype(np.float64)[:, win[yy, xx]]
    b = best[yy, xx].astype(np.float64)
    t = [(f[k] + xx * f[3 + k] + yy * f[6 + k]) / b for k in range(3)]
    uv = np.stack([f[30 + a] * t[0] + f[33 + a] * t[1] + f[36 + a] * t[2]
                   for a in range(2)])
    level = b / np.abs(f[39:41] - uv * f[41:43])
    lp = 2.0 ** np.ceil(np.log2(np.floor(np.clip(level, 1.0, 256.0))))
    return np.fmod(uv, 1.0) * lp


# Runs the Pallas kernel (interpret mode) on a saved setup table with XLA's
# CPU backend limited to AVX, which has no fused multiply-add: XLA then cannot
# contract a multiply and an add into one FMA, which it otherwise does on any
# CPU that has FMA3 (its loop fusions are compiled with FP-op fusion allowed).
_NO_FMA_RUN = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_platforms", "cpu")
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.ops import raster_pallas as jr
from swift3drenderer_tpu.renderer import scene_to_device
setup = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
textures = scene_to_device(SCENES["default"](seed=0))["textures"]
s = setup["live"].shape[0]
out = jr._rasterize_chunk(
    jax.tree.map(lambda a: a[None], setup), textures, width=320, height=240,
    background=DEFAULT_CONFIG.background_packed, tile_h=8, tile_w=128,
    y_offset=0, interpret=True, sampling="nearest",
    gids=jnp.arange(s, dtype=jnp.int32))
np.savez(sys.argv[2], *(np.asarray(a[0]) for a in out))
"""

# A far-floor pixel (row, column) whose texel the contraction flips at this
# pose: with FMA the Pallas kernel fetches a neighbouring texel, without it the
# port's.
_WITNESS = (143, 277)


def test_texel_boundary_pose_within_golden_bound(both_rasters, tmp_path):
    """bench.py's first flight pose (one step forward) puts far floor rows of
    the default scene on texel boundaries at 320x240. There the Pallas kernel
    (interpret mode, so XLA on the CPU) and the port disagree on texels: the
    tol-1 mismatch between them passes 5e-4. The witness: every flipped pixel
    has the same winner on both sides, is textured, and its float64 texel
    coordinate lies within 1e-3 texel of a texel boundary (a pixel's distance
    is spread over [0, 0.5]). Each side stays within 0.2 % of the golden
    oracle.

    The cause is XLA's multiply-add contraction on the CPU: rerun on the same
    setup table with contraction impossible (a subprocess, XLA limited to
    AVX), the Pallas kernel's pixels, depth and winners equal the port's bit
    for bit, _WITNESS and the other flipped pixels included. On a CPU without
    FMA3 the in-process run cannot contract either and flips nothing. Run
    with -s to see the numbers."""
    scene = SCENES["default"](seed=0)
    m = Camera().update(Input(up=1.0), force_update=True)
    setup = build_setup(scene_to_device(scene), jnp.asarray(m), width=W,
                        height=H, config=DEFAULT_CONFIG)
    (pj, dj, gj), (pix, depth, win) = both_rasters(setup)
    gp, _ = golden_render(scene, m, W, H)
    channels = [(p.astype(np.int64) >> k) & 255 for p in (pix, pj)
                for k in (16, 8, 0)]
    flipped = np.max([np.abs(channels[k] - channels[k + 3])
                      for k in range(3)], axis=0) > 1
    yy, xx = np.nonzero(flipped)
    trf, tri = tr.pack_setup_tables(to_torch(setup))
    coord = texel_coordinates_f64(trf, depth, win, yy, xx)
    to_boundary = np.abs(coord - np.round(coord)).min(axis=0)

    np.savez(tmp_path / "setup.npz", **{k: np.asarray(v)
                                        for k, v in setup.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-c", _NO_FMA_RUN, str(tmp_path / "setup.npz"),
         str(tmp_path / "nofma.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    nofma = np.load(tmp_path / "nofma.npz")
    pn, dn, gn = nofma["arr_0"], nofma["arr_1"], nofma["arr_2"]

    numbers = {"port_vs_pallas": pixel_mismatch_fraction(pix, pj),
               "port_vs_golden": pixel_mismatch_fraction(pix, gp),
               "pallas_vs_golden": pixel_mismatch_fraction(pj, gp),
               "flipped_pixels": int(flipped.sum()),
               "max_texels_to_boundary": float(to_boundary.max()),
               "port_vs_pallas_no_fma": pixel_mismatch_fraction(pix, pn),
               "pixels_differing_no_fma": int((pix != pn).sum()),
               "depth_differing_with_fma": int((depth != dj).sum())}
    print(numbers)
    assert (win == gj).mean() >= 0.9995
    both = (dj > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], dj[both], rtol=1e-4)
    assert numbers["port_vs_golden"] < 0.002
    assert numbers["pallas_vs_golden"] < 0.002
    if flipped.any():
        # This process's XLA contracted multiply-adds (a CPU with FMA3): the
        # flips are texel-boundary pixels of the same winners, the witness
        # among them.
        np.testing.assert_array_equal(win[flipped], gj[flipped])
        assert (tri[tr._ISTEX].numpy()[win[flipped]] == 1).all()
        assert to_boundary.max() < 1e-3
        assert flipped[_WITNESS] and pix[_WITNESS] != pj[_WITNESS]
        assert numbers["depth_differing_with_fma"] > 0
    # Without contraction: the same frame, bit for bit.
    assert numbers["port_vs_pallas_no_fma"] < 5e-4
    np.testing.assert_array_equal(pix, pn)
    np.testing.assert_array_equal(depth, dn)
    np.testing.assert_array_equal(win, np.where(dn > 0, gn, -1))


# The JAX package's whole Pallas frame (its front-end, then the Pallas
# kernel in interpret mode at 8-row tiles) under the identity camera at each
# size given, saved for the test below; run with XLA limited to AVX.
_NO_FMA_IDENTITY_RUN = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_platforms", "cpu")
from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.ops.raster_pallas import render_frame_pallas
from swift3drenderer_tpu.renderer import scene_to_device
dev = scene_to_device(SCENES["default"](seed=0))
m = jnp.asarray(Camera().update(Input(), force_update=True))
out = {}
for size in sys.argv[2:]:
    w, h = map(int, size.split("x"))
    pix, depth = render_frame_pallas(dev, m, width=w, height=h,
                                     interpret=True, tile_h=8)
    out[f"pix{size}"], out[f"depth{size}"] = np.asarray(pix), np.asarray(depth)
np.savez(sys.argv[1], **out)
"""


def test_identity_pose_equals_pallas_without_fma(tmp_path):
    """The identity camera on the default scene at 37x19, 96x64 and 128x96:
    frames whose floor pixels sit on texel boundaries, where XLA's CPU
    multiply-add contraction flips Pallas texels (1.7e-3 to 2.4e-2 at tol 1
    against the port in a process with FMA3). Without contraction (a
    subprocess with XLA limited to AVX) the JAX package's whole Pallas frame
    equals the port's (``Renderer(device="cpu")``) bit for bit, pixels and
    depth."""
    import swift3drenderer_tpu_torch as port
    from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES

    sizes = ["37x19", "96x64", "128x96"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-c", _NO_FMA_IDENTITY_RUN,
         str(tmp_path / "identity.npz"), *sizes],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(tmp_path / "identity.npz")
    ours = port.Renderer(PORT_SCENES["default"](seed=0), device="cpu")
    m = port.Camera().update(port.Input(), force_update=True)
    for size in sizes:
        w, h = map(int, size.split("x"))
        pix, depth = ours.render(m, w, h)
        np.testing.assert_array_equal(pix, ref[f"pix{size}"], err_msg=size)
        np.testing.assert_array_equal(depth, ref[f"depth{size}"],
                                      err_msg=size)
        assert (depth > 0).mean() > 0.2, size


@pytest.mark.parametrize("y0", [0, 61])
def test_tile_cull_drops_only_slots_that_cover_no_pixel(default_frames, y0):
    """The flat kernels' per-tile cull (csrc/raster.cu::tile_may_cover, as
    ``tile_cull_plain``) on the default scene's frames, whole and on a band
    at y0 > 0: every listed slot it drops covers no pixel of its tile at the
    visit's own rounding; it drops some, and every listed slot of some
    tiles."""
    _, frames = default_frames
    rows = H - y0 - 40 if y0 else H
    ntx = -(-W // tr.TILE_W)
    lane = torch.arange(tr.TILE_W * tr.TILE_H)
    whole = 0
    for setup in frames:
        st = to_torch(setup)
        ids, counts = tr.bin_triangles(st, width=W, height=rows,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W,
                                       y_offset=y0)
        trf, tri = tr.pack_setup_tables(st)
        keep = tr.tile_cull_plain(counts, ids, trf, tri, width=W,
                                  height=rows, y_offset=y0)
        listed = torch.arange(ids.shape[1])[None, :] < counts
        assert bool((keep <= listed).all())
        whole += int(((counts[:, 0] > 0) & ~keep.any(dim=1)).sum())
        tiles, j = torch.nonzero(listed & ~keep, as_tuple=True)
        s = ids[tiles, j].long()
        px = (tiles % ntx * tr.TILE_W)[:, None] + lane % tr.TILE_W
        py = (tiles // ntx * tr.TILE_H)[:, None] + lane // tr.TILE_W + y0
        f, i = trf[:, s, None], tri[:, s, None]
        cover = ((px >= i[tr._XMIN]) & (px <= i[tr._XMAX])
                 & (py >= i[tr._YMIN]) & (py <= i[tr._YMAX]))
        for k in range(3):
            cover &= (f[tr._W00 + k] + px.float() * f[tr._DX + k]
                      + py.float() * f[tr._DY + k]) >= 0
        assert s.numel() > 0 and not bool(cover.any())
    assert whole > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_ripmap_matches_jax(seed):
    """The nearest sampler against the JAX package's on seeded uv (negative,
    past 1, non-finite) and levels (below 1, past 256, non-finite)."""
    rng = np.random.default_rng(seed)
    n, nt = 4000, 3
    textures = rng.integers(0, 1 << 24, (nt, 512, 512)).astype(np.uint32)
    uv = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    level = np.exp(rng.uniform(-1.0, 7.0, (n, 2))).astype(np.float32)
    uv[:8] = [[np.nan, 0.5], [np.inf, -np.inf], [-0.0, 1.0], [0.999999, -1e-7],
              [1e30, -1e30], [0.25, 0.75], [0.5, np.nan], [-np.inf, 2.0]]
    level[:8] = [[np.nan, 1.0], [np.inf, -np.inf], [0.0, 256.0], [255.9, 1.5],
                 [3.0, 64.0], [1e9, 2.0], [np.nan, np.inf], [-5.0, 17.0]]
    tex_idx = rng.integers(-1, nt + 1, n).astype(np.int32)
    ref = np.asarray(jtexture.sample_ripmap(
        jnp.asarray(textures), jnp.asarray(tex_idx), jnp.asarray(uv),
        jnp.asarray(level)))
    ours = ttexture.sample_ripmap(
        torch.from_numpy(textures.view(np.int32)), torch.from_numpy(tex_idx),
        torch.from_numpy(uv), torch.from_numpy(level))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_fetched_texels_are_all_the_atlas_words_read(default_frames):
    """The plain raster reads no atlas word outside ``fetched_texels``: with
    every other word overwritten, each frame comes out the same."""
    dev, frames = default_frames
    textures = torch.from_numpy(np.array(dev["textures"]).view(np.int32))
    for setup in frames:
        st = to_torch(setup)
        ids, counts = tr.bin_triangles(st, width=W, height=H,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        trf, tri = tr.pack_setup_tables(st)
        best, win = tr.visibility_plain(counts, ids, trf, tri, width=W,
                                        height=H)
        words = tr.fetched_texels(best, win, trf, tri, textures.shape[0])
        assert 0 < words.numel() < textures.numel() // 4
        assert bool((words[1:] > words[:-1]).all())
        scrambled = torch.full_like(textures, 0x123456).reshape(-1)
        scrambled[words] = textures.reshape(-1)[words]
        pix = tr.shade_plain(best, win, trf, tri, textures, background=BG)
        again = tr.shade_plain(best, win, trf, tri,
                               scrambled.reshape(textures.shape),
                               background=BG)
        assert torch.equal(pix, again)


def test_wrapper_takes_plain_version_on_cpu(default_frames):
    dev, frames = default_frames
    st = to_torch(frames[1])
    textures = torch.from_numpy(np.array(dev["textures"]).view(np.int32))
    before = tr.raster_flat_nearest.launches
    pix, depth = tr.rasterize(st, textures, width=W, height=H, background=BG)
    ids, counts = tr.bin_triangles(st, width=W, height=H, tile_h=tr.TILE_H,
                                   tile_w=tr.TILE_W)
    trf, tri = tr.pack_setup_tables(st)
    pp, dp = tr.raster_flat_nearest_plain(counts, ids, trf, tri, textures,
                                          width=W, height=H, background=BG)
    assert pix.dtype == torch.int32 and tuple(pix.shape) == (H, W)
    assert torch.equal(pix, pp) and torch.equal(depth, dp)
    assert tr.raster_flat_nearest.launches == before   # no kernel launched
    with pytest.raises(ValueError):
        tr.raster_flat_nearest(counts.to("meta"), ids.to("meta"),
                               trf.to("meta"), tri.to("meta"),
                               textures.to("meta"), width=W, height=H,
                               background=BG)

