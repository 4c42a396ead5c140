"""The port's multi-device layer (``swift3drenderer_tpu_torch.parallel``) on
gloo process groups of CPU ranks.

One 8-rank world is spawned once for the file (``torch.multiprocessing``,
spawn start method, a ``FileStore``, one thread per rank); its sub-groups
give the 2-, 4-, 6- (not a power of two: the all_gather composite) and
8-rank meshes and the 2 x 4 (frame, fb) grid, whose scene composite runs the
butterfly along both axes. Each rank saves what it
rendered; the tests hold it against the port's single-device render (bit for
bit), the JAX package's ``render_scene_sharded`` on conftest's 8-device
virtual mesh (Pallas backend in interpret mode: pixel mismatch < 5e-4 at tol
1, depth rtol 1e-4, equal drawn sets) and golden (< 0.2 %).

The spawned ranks import this module, so it imports no JAX at the top: the
tests that need the JAX package import it themselves.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch.models import SCENES
from swift3drenderer_tpu_torch.parallel import (
    Mesh, ShardedRenderer, make_mesh, render_batch_sharded,
    render_scene_sharded)
from swift3drenderer_tpu_torch.renderer import render_frame, scene_to_device

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

WORLD = 8
SCENE_MESHES = ((1, 2), (1, 4), (1, 6), (1, 8), (2, 4))   # (n_frame, n_fb)
XLA_MESHES = ((1, 6), (2, 4))  # the backend="xla" composite: gather, butterfly
W, H = 128, 64
STRESS_OBJECTS = 64        # 771 triangles: every rank's range of at most 8
                           # takes the segmented route (> 125 slots)
BATCH = 4


def scene_pose():
    """The first of test_torch_ids's poses (test_fuzz's random poses, seed
    5002). From test_sharding's identity camera XLA's CPU multiply-add
    contraction flips floor texels of the JAX frame (ROADMAP queue 3): with
    it off (``XLA_FLAGS=--xla_cpu_max_isa=AVX``) that frame equals the
    port's bit for bit there too."""
    rng = np.random.default_rng(5002)
    cam = port.Camera()
    cam.update(port.Input(), force_update=True)
    for _ in range(rng.integers(1, 6)):
        cam.update(port.Input(
            up=float(rng.uniform(0, 2)), down=float(rng.uniform(0, 1)),
            left=float(rng.uniform(0, 1)), right=float(rng.uniform(0, 1)),
            mouse=(float(rng.uniform(-120, 120)), float(rng.uniform(-80, 80)))))
    return cam.matrix.astype(np.float32)


def batch_poses():
    """test_sharding's ``_cameras(4)``."""
    cam = port.Camera()
    return np.stack([cam.update(port.Input(right=float(i % 2)),
                                force_update=(i == 0)).copy()
                     for i in range(BATCH)]).astype(np.float32)


def scene_arrays(name):
    if name == "stress":
        return scene_to_device(SCENES["stress"](seed=0, objects=STRESS_OBJECTS),
                               "cpu")
    return scene_to_device(SCENES["default"](seed=0), "cpu")


def _rank_main(rank, store_path, out_dir):
    """One rank of the world: every mesh built in the same order on every
    rank, then each mesh's renders on its members; results to
    ``out_dir/rank<r>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        meshes = {shape: make_mesh(*shape, device="cpu")
                  for shape in SCENE_MESHES}
        grid = meshes[(2, 4)]
        try:
            make_mesh(1, WORLD + 1, device="cpu")
        except ValueError:
            out["too_many_raised"] = np.array(True)
        devs = {name: scene_arrays(name) for name in ("default", "stress")}
        m = torch.from_numpy(scene_pose())
        for (nf, nb), mesh in meshes.items():
            if not mesh.member:
                continue
            for name, dev in devs.items():
                pix, depth = render_scene_sharded(dev, m, width=W, height=H,
                                                  mesh=mesh)
                out[f"{name}_{nf}x{nb}_pix"] = pix.numpy()
                out[f"{name}_{nf}x{nb}_depth"] = depth.numpy()
            if (nf, nb) in XLA_MESHES:
                pix, depth = render_scene_sharded(
                    devs["default"], m, width=W, height=H, mesh=mesh,
                    backend="xla")
                out[f"xla_{nf}x{nb}_pix"] = pix.numpy()
                out[f"xla_{nf}x{nb}_depth"] = depth.numpy()
        sr = ShardedRenderer(SCENES["default"](seed=0), mesh=grid, device="cpu")
        ms = batch_poses()
        pix, depth = render_batch_sharded(sr.dev, torch.from_numpy(ms), width=W,
                                          height=H, mesh=grid)
        out["block_pix"], out["block_depth"] = pix.numpy(), depth.numpy()
        pix, depth = render_batch_sharded(sr.dev, torch.from_numpy(ms), width=W,
                                          height=H, mesh=grid, backend="xla")
        out["xla_block_pix"], out["xla_block_depth"] = pix.numpy(), depth.numpy()
        pix, depth = sr.render_batch(ms, W, H)
        out["batch_pix"], out["batch_depth"] = pix.numpy(), depth.numpy()
        pix, depth = ShardedRenderer(SCENES["default"](seed=0), mesh=grid,
                                     device="cpu", backend="xla").render_batch(
                                         ms, W, H)
        out["xla_batch_pix"], out["xla_batch_depth"] = pix.numpy(), depth.numpy()
    finally:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 8-rank world once; each rank's saved arrays, by rank."""
    tmp = tmp_path_factory.mktemp("gloo")
    mp.spawn(_rank_main, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD,
             join=True, start_method="spawn")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The port's single-device frame of each scene."""
    m = torch.from_numpy(scene_pose())
    return {name: tuple(t.numpy() for t in render_frame(
        scene_arrays(name), m, width=W, height=H))
        for name in ("default", "stress")}


def test_make_mesh_rejects_too_many_ranks(ranks):
    assert all(bool(r["too_many_raised"]) for r in ranks)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(1, 1, device="cpu")


@pytest.mark.parametrize("shape", SCENE_MESHES)
@pytest.mark.parametrize("name", ["default", "stress"])
def test_scene_sharded_equals_single_device(ranks, single, name, shape):
    """render_scene_sharded over a (n_frame, n_fb) mesh: every rank of the
    mesh holds the single-device frame, pixels and depth bit for bit (the
    butterfly for 2, 4 and 8 ranks and along both axes of the 2 x 4 grid,
    the all_gather merge for 6); ranks outside hold nothing."""
    pix, depth = single[name]
    assert (depth > 0).mean() > 0.3
    key = f"{name}_{shape[0]}x{shape[1]}"
    for r in range(WORLD):
        if r >= shape[0] * shape[1]:
            assert f"{key}_pix" not in ranks[r]
            continue
        np.testing.assert_array_equal(ranks[r][f"{key}_pix"], pix)
        np.testing.assert_array_equal(ranks[r][f"{key}_depth"], depth)


def test_xla_backend_sharded_equals_single_xla_frames(ranks):
    """The backend="xla" branches. render_scene_sharded: each rank
    rasterizes a slot range of the full setup table with ops.raster_xla,
    and the composite (all_gather merge on 6 ranks, butterfly on the 2 x 4
    grid) equals the single render_frame_xla frame on every rank of the
    mesh, bit for bit. render_batch_sharded on the 2 x 4 grid: rank (f, b)
    holds its block of Renderer(backend="xla").render_batch's batch, and
    ShardedRenderer(backend="xla").render_batch gives every rank the whole
    batch."""
    from swift3drenderer_tpu_torch.renderer import render_frame_xla

    pix, depth = (t.numpy() for t in render_frame_xla(
        scene_arrays("default"), torch.from_numpy(scene_pose()), width=W,
        height=H))
    assert (depth > 0).mean() > 0.3
    for nf, nb in XLA_MESHES:
        for r in range(nf * nb):
            np.testing.assert_array_equal(ranks[r][f"xla_{nf}x{nb}_pix"], pix)
            np.testing.assert_array_equal(ranks[r][f"xla_{nf}x{nb}_depth"],
                                          depth)
    pix, depth = (t.numpy() for t in port.Renderer(
        SCENES["default"](seed=0), device="cpu", backend="xla")
        .render_batch(batch_poses(), W, H))
    lb, lh = BATCH // 2, H // 4
    for r in range(WORLD):
        f, b = divmod(r, 4)
        np.testing.assert_array_equal(
            ranks[r]["xla_block_pix"],
            pix[f * lb:(f + 1) * lb, b * lh:(b + 1) * lh])
        np.testing.assert_array_equal(
            ranks[r]["xla_block_depth"],
            depth[f * lb:(f + 1) * lb, b * lh:(b + 1) * lh])
        np.testing.assert_array_equal(ranks[r]["xla_batch_pix"], pix)
        np.testing.assert_array_equal(ranks[r]["xla_batch_depth"], depth)


def test_scene_sharded_matches_jax_render_scene_sharded(ranks):
    """The port's 8-rank frame against the JAX package's render_scene_sharded
    on the 8-device virtual mesh (Pallas backend, interpret mode), and
    golden."""
    import jax.numpy as jnp
    from swift3drenderer_tpu.golden import render_frame as golden_render
    from swift3drenderer_tpu.parallel.sharding import (
        make_mesh as jax_make_mesh, render_scene_sharded as jax_scene_sharded)
    from swift3drenderer_tpu.renderer import scene_to_device as jax_to_device
    from conftest import pixel_mismatch_fraction

    scene = SCENES["default"](seed=0)
    m = scene_pose()
    jp, jd = (np.asarray(a) for a in jax_scene_sharded(
        jax_to_device(scene), jnp.asarray(m), width=W, height=H,
        mesh=jax_make_mesh(1, 8), backend="pallas", interpret=True))
    pix = ranks[0]["default_1x8_pix"].view(np.uint32)
    depth = ranks[0]["default_1x8_depth"]
    np.testing.assert_array_equal(depth > 0, jd > 0)
    assert pixel_mismatch_fraction(pix, jp, tol=1) < 5e-4
    both = depth > 0
    np.testing.assert_allclose(depth[both], jd[both], rtol=1e-4)
    gp, _ = golden_render(scene, m, W, H)
    assert pixel_mismatch_fraction(pix, gp, tol=1) < 0.002


def test_batch_sharded_equals_render_batch(ranks):
    """render_batch_sharded on the 2 x 4 grid: rank (f, b) holds frames
    [2f, 2f + 2) rows [16b, 16b + 16) of Renderer.render_batch's batch, bit
    for bit, and ShardedRenderer.render_batch gives every rank the whole
    batch; each frame within 0.2 % of golden."""
    from swift3drenderer_tpu.golden import render_frame as golden_render
    from conftest import pixel_mismatch_fraction

    scene = SCENES["default"](seed=0)
    ms = batch_poses()
    pix, depth = (t.numpy() for t in port.Renderer(scene, device="cpu")
                  .render_batch(ms, W, H))
    lb, lh = BATCH // 2, H // 4
    for r in range(WORLD):
        f, b = divmod(r, 4)
        np.testing.assert_array_equal(
            ranks[r]["block_pix"], pix[f * lb:(f + 1) * lb, b * lh:(b + 1) * lh])
        np.testing.assert_array_equal(
            ranks[r]["block_depth"], depth[f * lb:(f + 1) * lb, b * lh:(b + 1) * lh])
        np.testing.assert_array_equal(ranks[r]["batch_pix"], pix)
        np.testing.assert_array_equal(ranks[r]["batch_depth"], depth)
    for i in range(BATCH):
        gp, _ = golden_render(scene, ms[i], W, H)
        assert pixel_mismatch_fraction(pix[i].view(np.uint32), gp, tol=1) < 0.002
    assert (depth > 0).mean() > 0.2


def test_batch_sharded_rejects_indivisible_shapes():
    """The JAX function's errors, raised before any collective: a height the
    fb axis does not divide, a batch the frame axis does not divide, and a
    rank outside the mesh."""
    dev = scene_arrays("default")
    grid = Mesh(2, 4, 0, torch.device("cpu"), None, None, None)
    ms = torch.from_numpy(batch_poses())
    with pytest.raises(ValueError, match="not divisible"):
        render_batch_sharded(dev, ms, width=W, height=90, mesh=grid)
    with pytest.raises(ValueError, match="not divisible"):
        render_batch_sharded(dev, ms[:3], width=W, height=H, mesh=grid)
    outside = Mesh(1, 2, 5, torch.device("cpu"), None, None, None)
    with pytest.raises(ValueError, match="not in the"):
        render_scene_sharded(dev, ms[0], width=W, height=H, mesh=outside)


def test_sharded_renderer_rejects_an_unknown_backend():
    """ShardedRenderer(backend=) takes the port's backends, "cuda" and
    "xla", and raises on any other (the JAX package's "pallas" included)
    before it uploads the scene."""
    mesh = Mesh(1, 1, 0, torch.device("cpu"), None, None, None)
    with pytest.raises(ValueError, match="unknown backend"):
        ShardedRenderer(SCENES["default"](seed=0), mesh=mesh, device="cpu",
                        backend="pallas")
    sr = ShardedRenderer(SCENES["default"](seed=0), mesh=mesh, device="cpu",
                         backend="xla")
    assert sr.backend == "xla" and sr.graphs is None
