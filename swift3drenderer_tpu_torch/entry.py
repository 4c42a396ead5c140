"""Entry hooks of the port: the counterparts of ``__graft_entry__.entry()``
and ``__graft_entry__.dryrun_multichip(n_devices)``.

    from swift3drenderer_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()          # device="cpu" for the plain versions
    pixels = fn(*args)          # (480, 640) int32 0x00RRGGBB on the device
    dryrun_multichip(4)         # 4 NCCL ranks, one a card; device="cpu": gloo

    python -m swift3drenderer_tpu_torch.entry     # both, on every card

``entry`` renders one 640x480 frame of the default scene (seed 0) at the
identity camera through the port's main path:
``Renderer(backend="cuda").render_device`` (a captured graph on the card).
The JAX hook renders through ``render_frame_xla`` under ``jax.jit``.

``dryrun_multichip`` runs the sharded paths over an n-rank (frame, fb) mesh
of ``torch.distributed`` ranks, one process each, at tiny shapes.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .camera import Camera, Input
from .convert import resolve_device
from .models import default_scene
from .ops import raster
from .parallel import (gather_batch, make_mesh, render_batch_sharded,
                       render_scene_sharded)
from .renderer import (BACKENDS, Renderer, render_frame_xla, render_frames,
                       scene_to_device)

WIDTH, HEIGHT = 640, 480
DRYRUN_WIDTH = 128
DRYRUN_BAND_ROWS = 8        # one 8-row band per fb rank
KERNEL_WRAPPERS = (raster.raster_flat_nearest, raster.raster_flat_bilinear,
                   raster.raster_segmented_nearest,
                   raster.raster_segmented_bilinear)


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(renderer, matrix)`` renders one frame
    and returns its pixels."""
    renderer = Renderer(default_scene(seed=0), device=device)
    m = Camera().update(Input(), force_update=True)

    def fn(r, matrix):
        pixels, _ = r.render_device(matrix, WIDTH, HEIGHT)
        return pixels

    return fn, (renderer, m)


def dryrun_mesh(n_devices: int):
    """The hook's (n_frame, n_fb) factorisation of ``n_devices``, the JAX
    hook's: two frame ranks when n is even and above 2, fb ranks for the
    rest."""
    n_frame = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    return n_frame, n_devices // n_frame


def _same(got, want, what: str) -> None:
    for a, b in zip(got, want):
        if tuple(a.shape) != tuple(b.shape) or not torch.equal(a, b):
            raise RuntimeError(f"dryrun_multichip: {what} is not the "
                               "single-device frame bit for bit")


def _dryrun_rank(rank: int, n_devices: int, kind: str, tmp: str) -> None:
    """One rank of the dry run: its process group (a FileStore in ``tmp``,
    so that no other world in the caller's process meets it), the mesh,
    then ``render_batch_sharded`` (gathered) and ``render_scene_sharded``
    through each backend, each held to the single-device frames on this
    rank's device bit for bit. Writes ``tmp/rank<r>.json``."""
    if kind == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 n_devices),
                            rank=rank, world_size=n_devices)
    try:
        mesh = make_mesh(*dryrun_mesh(n_devices), device=device)
        dev = scene_to_device(default_scene(seed=0), device)
        cam = Camera()
        ms = torch.as_tensor(np.stack([
            cam.update(Input(right=1.0), force_update=(i == 0)).copy()
            for i in range(2 * mesh.n_frame)]).astype(np.float32),
            device=device)
        height = DRYRUN_BAND_ROWS * mesh.n_fb
        size = dict(width=DRYRUN_WIDTH, height=height)
        launches = {}

        def counted(fn):
            """``fn()``, adding the kernels it launched to ``launches`` (the
            single-device references are not counted)."""
            for w in KERNEL_WRAPPERS:
                w.launches = w.launches_ids = 0
            out = fn()
            for w in KERNEL_WRAPPERS:
                for name, n in ((w.__name__, w.launches),
                                (f"{w.__name__}_ids", w.launches_ids)):
                    launches[name] = launches.get(name, 0) + n
            return out

        for backend in BACKENDS:
            batch = counted(lambda: gather_batch(mesh, *render_batch_sharded(
                dev, ms, **size, mesh=mesh, backend=backend)))
            _same(batch, render_frames(dev, ms, **size, backend=backend),
                  f"the gathered {backend} batch")
            scene = counted(lambda: render_scene_sharded(
                dev, ms[0], **size, mesh=mesh, backend=backend))
            if backend == "xla":
                single = render_frame_xla(dev, ms[0], **size)
            else:
                single = tuple(p[0] for p in render_frames(dev, ms[:1],
                                                           **size))
            _same(scene, single, f"the {backend} triangle-sharded composite")
        report = {"batch": list(batch[0].shape), "scene": list(scene[0].shape),
                  "launches": launches}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: an n-rank
    (frame, fb) mesh (``dryrun_mesh``), one process a rank started with
    ``torch.multiprocessing`` (spawn), each rendering at tiny shapes (a
    128-wide frame, 8 rows per fb rank, 2 * n_frame poses of
    ``Input(right=1.0)``) the camera batch over the mesh
    (``render_batch_sharded``, then ``gather_batch``) and the
    triangle-sharded frame (``render_scene_sharded``), each through the
    ``cuda`` and ``xla`` backends. The JAX hook checks shapes; here every
    rank holds the gathered batch and each composite to the single-device
    frames bit for bit, and a rank that fails makes this raise.

    ``device="cuda"``: one NCCL rank per card, which needs ``n_devices``
    cards; with fewer it raises before starting a rank, saying how many it
    found (nothing falls back to the CPU). ``device="cpu"``: ``n_devices``
    gloo ranks, the counterpart of the JAX hook's virtual CPU devices.

    Prints one ``dryrun_multichip OK: ...`` line in the JAX hook's wording
    and returns the mesh, the shapes and each rank's kernel launches."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, not {n_devices}")
    kind = torch.device(device).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                           f"CUDA cards, one a rank; found "
                           f"{torch.cuda.device_count()}")
    resolve_device(device)
    n_frame, n_fb = dryrun_mesh(n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_rank, args=(n_devices, kind, tmp),
                           nprocs=n_devices, join=True, start_method="spawn")
        reports = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    shape = tuple(reports[0]["batch"])
    print(f"dryrun_multichip OK: mesh=(frame={n_frame}, fb={n_fb}), "
          f"pixels {shape} sharded over {n_devices} devices, "
          f"{'+'.join(BACKENDS)} backends; triangle-sharded butterfly "
          f"composite (render_scene_sharded) OK on the same mesh, "
          f"{'+'.join(BACKENDS)}", flush=True)
    return {"mesh": (n_frame, n_fb), "device": kind, "batch": shape,
            "scene": tuple(reports[0]["scene"]),
            "launches": [r["launches"] for r in reports]}


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", tuple(out.shape), out.dtype)
    dryrun_multichip(torch.cuda.device_count())
