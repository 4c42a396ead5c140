"""The key logic of ``graphs.GraphCache``, the graph cache that
``parallel.render_scene_sharded`` keeps as ``jax.jit`` keeps its
executables, on CPU tensors with no graph: each entry's value comes from the
``make`` the call passes (a plain object here, a ``FrameGraphs`` on the
card). Under a second on one process, imports aside.
"""

import types

import pytest
import torch

from swift3drenderer_tpu_torch.graphs import GraphCache
from swift3drenderer_tpu_torch.models import SCENES
from swift3drenderer_tpu_torch.parallel import render_scene_sharded, sharding
from swift3drenderer_tpu_torch.renderer import scene_to_device

torch.set_num_threads(1)

STATIC = ("scene", 64, 48, "config", "cuda", "mesh")


def scene_dict():
    return {"vert_c": torch.zeros(4, 3, 4), "textures": torch.zeros(2, 8)}


def made(cache, static, tensors):
    """The entry's value and whether this call made it."""
    fresh = object()
    value = cache.entry(static, tensors, lambda: fresh)
    return value, value is fresh


def test_same_tensors_hit_and_a_new_dict_of_them_too():
    cache = GraphCache(4)
    dev = scene_dict()
    first, new = made(cache, STATIC, list(dev.values()))
    assert new
    again, new = made(cache, STATIC, list(dev.values()))
    assert again is first and not new
    copy = dict(dev)
    again, new = made(cache, STATIC, list(copy.values()))
    assert again is first and not new and len(cache) == 1


def test_remade_tensor_of_the_same_shape_misses():
    """A tensor made again (equal shape and values, another object) is
    another entry: a graph baked in the first tensor's address."""
    cache = GraphCache(4)
    dev = scene_dict()
    first, _ = made(cache, STATIC, list(dev.values()))
    remade = dict(dev, vert_c=dev["vert_c"].clone())
    second, new = made(cache, STATIC, list(remade.values()))
    assert new and second is not first and len(cache) == 2


def test_other_static_arguments_miss():
    cache = GraphCache(4)
    tensors = list(scene_dict().values())
    first, _ = made(cache, STATIC, tensors)
    for static in (STATIC[:1] + (65,) + STATIC[2:],
                   STATIC[:4] + ("xla",) + STATIC[5:]):
        other, new = made(cache, static, tensors)
        assert new and other is not first
    assert len(cache) == 3


def test_dead_tensor_evicts_its_entry():
    """A tensor of an entry dies: the next call drops the entry, and a new
    tensor that reuses the dead one's id is a miss, never its graph."""
    cache = GraphCache(4)
    keep = scene_dict()
    dead = scene_dict()
    kept, _ = made(cache, STATIC, list(keep.values()))
    made(cache, STATIC, list(dead.values()))
    assert len(cache) == 2
    del dead                    # no cycle holds it: it dies here
    again, new = made(cache, STATIC, list(keep.values()))
    assert again is kept and not new and len(cache) == 1
    for _ in range(50):         # a fresh tensor often takes a freed id
        dev = scene_dict()
        _, new = made(cache, STATIC, list(dev.values()))
        assert new
        del dev
    assert len(cache) == 2


def test_capture_stats_are_the_live_entry_s():
    """Two scenes under one static key keep their own capture stats."""
    cache = GraphCache(4)
    devs = [scene_dict() for _ in range(2)]
    for i, dev in enumerate(devs):
        cache.entry(STATIC, list(dev.values()), lambda i=i: types.SimpleNamespace(
            captured={STATIC: {"capture_ms": float(i)}}))
    for i, dev in enumerate(devs):
        assert cache.capture_stats(STATIC, list(dev.values())) == {
            "capture_ms": float(i)}
    with pytest.raises(KeyError):
        cache.capture_stats(STATIC, list(scene_dict().values()))


def test_least_recently_used_goes_past_the_bound():
    cache = GraphCache(2)
    devs = [scene_dict() for _ in range(3)]
    a, _ = made(cache, STATIC, list(devs[0].values()))
    made(cache, STATIC, list(devs[1].values()))
    made(cache, STATIC, list(devs[0].values()))     # devs[0] used last
    made(cache, STATIC, list(devs[2].values()))     # devs[1] goes
    assert len(cache) == 2
    again, new = made(cache, STATIC, list(devs[0].values()))
    assert again is a and not new
    _, new = made(cache, STATIC, list(devs[1].values()))
    assert new
    with pytest.raises(ValueError):
        GraphCache(0)


def test_render_scene_sharded_keeps_a_bounded_cache_and_the_cpu_stays_eager():
    """The free function's cache holds at most SCENE_GRAPHS_MAX entries; a
    CPU call runs eagerly, captures nothing and fills no entry."""
    cache = render_scene_sharded.graphs
    assert isinstance(cache, GraphCache)
    assert cache.max_entries == sharding.SCENE_GRAPHS_MAX
    dev = scene_to_device(SCENES["tetrahedron"](seed=0), "cpu")
    mesh = sharding.Mesh(1, 2, 1, torch.device("cpu"), None, None, None)
    before = (len(cache), cache.captures, cache.replays)
    m = torch.eye(3, 4)
    m[2, 3] = 3.0
    packed, graphed = sharding._packed_range(
        dev, m, width=32, height=24, config=sharding.DEFAULT_CONFIG,
        mesh=mesh, backend="cuda")
    assert not graphed and tuple(packed.shape) == (3, 24, 32)
    assert (len(cache), cache.captures, cache.replays) == before
