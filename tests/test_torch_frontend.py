"""The front-end kernel ``ops.frontend.frontend_setup`` (csrc/frontend.cu):
vertex and normal products, projection, near-plane clip prepass and setup
table in one launch, against its plain PyTorch version
``frontend_setup_plain`` (the chain of ``ops.vertex``, ``ops.clip`` and
``ops.setup``).

On the CPU (tier-1): CPU tensors take the plain version and launch nothing;
the wrapper refuses a wrong dtype, shape, device constant or a
non-contiguous input instead of running anything; the straddling scene the
card tests use reaches every near-plane case.

On the card (``-m cuda``): the kernel's setup table equals the plain
version's on the card bit for bit, every key, float bits compared as int32
so that NaN compares too: the benchmark's default and stress840 scenes over
their flights, a scene of straddling triangles in every near-plane case, a
batch of four and a bucketed frame with its constants in device tensors;
and the renderer's captured frame equals the frame rendered with the plain
front-end.

The file imports neither JAX nor the JAX package, so the card tests run
where only PyTorch is installed, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_frontend.py -q
"""

import numpy as np
import pytest
import torch

import swift3drenderer_tpu_torch as port
from s3dbench import flight, scenegen, spec
from swift3drenderer_tpu_torch import renderer as trenderer
from swift3drenderer_tpu_torch.ops import frontend as tf
from swift3drenderer_tpu_torch.renderer import (build_setup, frame_dims,
                                                scene_to_device)

torch.set_num_threads(1)

CFG = port.DEFAULT_CONFIG
# Each config's cell at the app's size, whose scene and flight the card
# tests take.
CELLS = {"default": "default-1080p-frame",
         "stress840": "stress840-1080p-frame"}
# The straddling scene's view depths: behind the camera, at 0, behind the
# near plane, at it (float32(0.1) is not in front), in front.
DEPTHS = (-0.5, 0.0, 0.05, 0.1, 0.3, 1.0, 2.0)


def bench_scene(config: str, seed: int = 1):
    """(Scene, poses (n, 3, 4)) of ``config``'s benchmark cell at 1080p."""
    cell = spec.cell(CELLS[config])
    scene = port.Scene(**scenegen.build(cell.config, seed))
    return scene, flight.walk(cell.traffic["flight"])


def straddle_arrays(seed: int = 0, count: int = 240) -> dict:
    """Corner-major arrays (``scene_to_device``'s keys but the textures) of
    triangles given by their view depths under the identity pose: one of
    each near-plane case with the near-side corners at every position, a
    pair of equal depths in an all-behind and an all-in-front triangle (the
    appended slot's crossings then divide by 0), corners on the near plane,
    corners at depth 0 on the view axis (NaN raster corners), then
    ``count`` triangles with depths and positions drawn from ``seed``."""
    fixed = [(0.05, -0.5, 0.02), (2.0, 1.0, 3.0), (0.05, 0.05, 0.05),
             (1.0, 2.0, 2.0), (0.1, 0.1, 1.0), (0.0, 0.0, 1.0)]
    for d in ((1.0, 0.05, -0.5), (1.0, 2.0, 0.05)):
        fixed += [d[k:] + d[:k] for k in range(3)]
    rng = np.random.default_rng(seed)
    depths = np.concatenate([np.asarray(fixed, np.float32),
                             rng.choice(np.asarray(DEPTHS, np.float32),
                                        (count, 3))])
    t = depths.shape[0]
    xy = rng.uniform(-3.0, 3.0, (t, 3, 2)).astype(np.float32)
    xy[rng.random((t, 3)) < 0.2] = 0.0
    xy[5] = 0.0                              # (0, 0, 0): 0 * factor / 0
    vert = np.concatenate([xy, -depths[..., None],
                           np.ones((t, 3, 1), np.float32)], axis=-1)
    norm = np.concatenate([rng.normal(size=(t, 3, 3)).astype(np.float32),
                           np.zeros((t, 3, 1), np.float32)], axis=-1)
    return dict(vert_c=vert, norm_c=norm,
                attr_c=rng.uniform(0.0, 1.0, (t, 3, 3)).astype(np.float32),
                tex_c=rng.integers(-1, 2, t).astype(np.int32))


IDENTITY = np.eye(3, 4, dtype=np.float32)


def to_torch(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def front_args(dev: dict) -> tuple:
    return dev["vert_c"], dev["norm_c"], dev["attr_c"], dev["tex_c"]


def exact_dims(width: int, height: int) -> dict:
    """``build_setup``'s constants of the exact-size frame."""
    return dict(width=width, height=height, factor=CFG.factor(height),
                half_w=width / 2.0, half_h=height / 2.0)


def bucket_dims(width: int, height: int, device) -> dict:
    """The same constants as 0-dim float32 tensors on ``device``, as
    ``render_frames_bucketed`` hands them over (views of ``frame_dims``)."""
    d = torch.from_numpy(frame_dims(width, height, CFG)).to(device)
    return dict(zip(("width", "height", "factor", "half_w", "half_h"), d))


def setup_bits(setup: dict) -> dict:
    """Each array of a setup table on the host, float32 as its int32 bits."""
    return {k: (v.cpu().view(torch.int32) if v.dtype == torch.float32
                else v.cpu()).numpy() for k, v in setup.items()}


def assert_same_table(got: dict, want: dict) -> None:
    """Every key, dtype, shape and bit."""
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    gb, wb = setup_bits(got), setup_bits(want)
    for k in want:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def both(dev: dict, m: torch.Tensor, dims: dict) -> tuple:
    """(kernel, plain) setup tables of ``m``, the kernel launched once."""
    kw = dict(near=CFG.near, min_area=CFG.min_area, **dims)
    before = tf.frontend_setup.launches
    got = tf.frontend_setup(*front_args(dev), m, **kw)
    assert tf.frontend_setup.launches == before + 1
    return got, tf.frontend_setup_plain(*front_args(dev), m, **kw)


# ---------------------------------------------------------------------------
# CPU (tier-1)

def test_cpu_tensors_take_the_plain_version():
    """On the CPU ``build_setup`` is the plain chain, key for key and bit for
    bit, and launches nothing: a single pose, a batch and the bucketed
    frame's device-scalar constants."""
    scene, poses = bench_scene("default")
    dev = scene_to_device(scene, "cpu")
    w, h = 160, 90
    before = tf.frontend_setup.launches
    for m in (torch.from_numpy(poses[7]), torch.from_numpy(poses[:4])):
        got = build_setup(dev, m, width=w, height=h, config=CFG)
        want = tf.frontend_setup_plain(*front_args(dev), m, near=CFG.near,
                                       min_area=CFG.min_area,
                                       **exact_dims(w, h))
        assert_same_table(got, want)
        assert got["live"].shape[:-1] == m.shape[:-2]
    d = bucket_dims(w, h, "cpu")
    bucketed = build_setup(dev, torch.from_numpy(poses[:4]), width=d["width"],
                           height=d["height"], config=CFG,
                           proj=(d["factor"], d["half_w"], d["half_h"]))
    assert_same_table(bucketed, got)
    assert tf.frontend_setup.launches == before


def test_straddle_scene_reaches_every_near_plane_case():
    """The card tests' straddling scene holds triangles with 0, 1, 2 and 3
    corners in front of the near plane, a corner on it, equal depths on an
    appended slot's crossing edge (NaN and inf lanes) and NaN raster
    corners; and its plain table keeps a live slot of each straddling case."""
    arrays = straddle_arrays()
    z = -arrays["vert_c"][..., 2]
    front = (z > np.float32(CFG.near)).sum(axis=1)
    assert set(front.tolist()) == {0, 1, 2, 3}
    assert (z == np.float32(CFG.near)).any()
    flat = (front == 0) | (front == 3)
    assert (flat & ((z[:, 1] == z[:, 2]) | (z[:, 2] == z[:, 0]))).any()
    setup = tf.frontend_setup(
        *front_args(to_torch(arrays, "cpu")), torch.from_numpy(IDENTITY),
        near=CFG.near, min_area=CFG.min_area, **exact_dims(640, 480))
    live = setup["live"].reshape(-1, 2).numpy()
    assert live[front == 1, 0].any() and live[front == 2, 1].any()
    assert live[front == 3, 0].any() and not live[front == 0].any()
    assert not np.isfinite(setup["w00"].numpy()).all()


# (input, how it is made unfit): a wrong dtype, shape or a non-contiguous
# layout, one input at a time.
UNFIT = [
    ("vert_c", lambda a: a.double()),
    ("norm_c", lambda a: a[:-1]),
    ("attr_c", lambda a: a.transpose(1, 2)),
    ("tex_c", lambda a: a.long()),
    ("m", lambda a: a.t()),
    ("m", lambda a: a.double()),
    ("m", lambda a: a[None, None]),
    ("m", lambda a: a.reshape(4, 3)),
]


@pytest.mark.parametrize("name, how", UNFIT,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(UNFIT)])
def test_wrapper_refuses_unfit_inputs(name, how):
    """A wrong dtype, shape or a non-contiguous input raises before anything
    runs, on either device: nothing falls back to a converting copy."""
    args = dict(zip(("vert_c", "norm_c", "attr_c", "tex_c"),
                    front_args(to_torch(straddle_arrays(count=8), "cpu"))))
    args["m"] = torch.from_numpy(IDENTITY)
    args[name] = how(args[name])
    before = tf.frontend_setup.launches
    with pytest.raises(ValueError, match=name):
        tf.frontend_setup(**args, near=CFG.near, min_area=CFG.min_area,
                          **exact_dims(64, 48))
    assert tf.frontend_setup.launches == before


def test_wrapper_refuses_mixed_constants():
    """The five constants are all Python numbers or all 0-dim float32
    tensors; a mix, or a tensor of another dtype or shape, raises."""
    dev = to_torch(straddle_arrays(count=8), "cpu")
    m = torch.from_numpy(IDENTITY)
    d = bucket_dims(64, 48, "cpu")
    for dims in ({**exact_dims(64, 48), "factor": d["factor"]},
                 {**d, "height": d["height"].double()},
                 {**d, "half_w": d["half_w"][None]}):
        with pytest.raises(ValueError):
            tf.frontend_setup(*front_args(dev), m, near=CFG.near,
                              min_area=CFG.min_area, **dims)


# ---------------------------------------------------------------------------
# The card

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CELLS))
def test_frontend_matches_plain_over_flight_on_cuda(config):
    """The benchmark's scene over its flight at 1920x1080 (every 8th pose):
    one launch a pose, bit for bit the plain version on the card."""
    need_card()
    scene, poses = bench_scene(config)
    dev = scene_to_device(scene, "cuda")
    for m in poses[::8]:
        got, want = both(dev, torch.as_tensor(m, device="cuda"),
                         exact_dims(1920, 1080))
        assert_same_table(got, want)
        assert bool(got["live"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("pose", ["identity", "flight"])
def test_frontend_matches_plain_on_straddling_triangles_on_cuda(pose):
    """Every near-plane case, crossings that divide by 0 and NaN raster
    corners, under the identity pose (the cases as built) and under flight
    poses (other splits): bit for bit, NaN lanes included."""
    need_card()
    dev = to_torch(straddle_arrays(), "cuda")
    ms = ([IDENTITY] if pose == "identity"
          else bench_scene("default")[1][::32])
    for m in ms:
        got, want = both(dev, torch.as_tensor(m, device="cuda"),
                         exact_dims(640, 480))
        assert_same_table(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CELLS))
def test_frontend_batch_matches_plain_on_cuda(config):
    """B = 4 in one launch: bit for bit the plain batch, and each frame's
    table that of its pose alone."""
    need_card()
    scene, poses = bench_scene(config)
    dev = scene_to_device(scene, "cuda")
    ms = torch.as_tensor(np.ascontiguousarray(poses[3:67:16]), device="cuda")
    got, want = both(dev, ms, exact_dims(3840, 2160))
    assert_same_table(got, want)
    for b in range(4):
        one, _ = both(dev, ms[b], exact_dims(3840, 2160))
        assert_same_table({k: v[b] for k, v in got.items()}, one)


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CELLS))
def test_frontend_bucketed_matches_plain_on_cuda(config):
    """A bucketed frame's constants as 0-dim device tensors (views of
    ``frame_dims``, as ``render_frames_bucketed`` passes them): bit for bit
    the plain version, and the exact-size kernel's table."""
    need_card()
    scene, poses = bench_scene(config)
    dev = scene_to_device(scene, "cuda")
    ms = torch.as_tensor(poses[5:9], device="cuda")
    for w, h in ((1366, 768), (333, 217)):
        got, want = both(dev, ms, bucket_dims(w, h, "cuda"))
        assert_same_table(got, want)
        exact, _ = both(dev, ms, exact_dims(w, h))
        assert_same_table(got, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CELLS))
def test_render_device_matches_plain_frontend_on_cuda(config, monkeypatch):
    """``Renderer.render_device``, the front-end kernel captured in the
    frame's graph, against the same frame rendered eagerly with the plain
    front-end on the card: pixels and depth bit for bit, 1920x1080."""
    need_card()
    scene, poses = bench_scene(config)
    r = port.Renderer(scene, device="cuda")
    before = tf.frontend_setup.launches
    frames = [r.render_device(m, 1920, 1080) for m in poses[::64]]
    # The warm-up and the capture launch it; the replays go without it.
    assert tf.frontend_setup.launches == before + 2
    monkeypatch.setattr(trenderer, "frontend_setup", tf.frontend_setup_plain)
    for m, (pix, depth) in zip(poses[::64], frames):
        pp, dp = trenderer.render_frame(r.dev, torch.as_tensor(m, device="cuda"),
                                        width=1920, height=1080, config=CFG)
        assert torch.equal(pix, pp) and torch.equal(depth, dp)
    assert tf.frontend_setup.launches == before + 2
