"""Counterpart of the repo's ``tools/probe_dynamic_grid.py``: a chunk loop
whose bound the kernel reads from device memory, with an asynchronous copy at
an index derived from the chunk.

Each of NT = 3 tiles sums, over chunks ``c < nc``, ``tab[c * 8, 0] +
float(hbm[t * NCMAX + c, 0, 0])`` into its (8, 128) output block. ``nc`` is a
0-d int32 tensor on the device: the kernel reads it, the host never does, so
a live count computed on the card can bound a loop without a device-to-host
copy. On the TPU the chunks are a grid axis of traced length and the output
block is revisited; on the card they live inside each tile's block
(``csrc/probes.cu``, ``probe_dynamic_grid_kernel``), which issues the bulk
copies (Hopper's ``cp.async.bulk``) of all its ``nc`` hbm rows at once into
slots of one shared-memory buffer, their bytes counted on one mbarrier, and
waits once: a call costs its launch and one copy's round trip, whatever the
count; at ``nc = 0`` (no copy) it costs the launch alone.

    python -m swift3drenderer_tpu_torch.tools.probe_dynamic_grid [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import resolve_device
from . import _probe

NT = 3        # tiles
NCMAX = 4     # static chunk capacity
CHUNKS = (1, 2, 3, 4)
# Lane operations of one (tile, chunk, output element), counted from the
# kernel's source: the tab load, the shared-memory load, the conversion and
# two adds.
OPS_PER_CHUNK = 5


def inputs(device):
    """The tool's (tab, hbm) on ``device``: tab f32 arange (NCMAX * 8, 128),
    hbm i32 arange (NT * NCMAX, 8, 128)."""
    dev = resolve_device(device)
    tab = torch.arange(NCMAX * 8 * 128, dtype=torch.float32).reshape(
        NCMAX * 8, 128)
    hbm = torch.arange(NT * NCMAX * 8 * 128, dtype=torch.int32).reshape(
        NT * NCMAX, 8, 128)
    return tab.to(dev), hbm.to(dev)


def expected(tab: np.ndarray, hbm: np.ndarray, nc: int) -> np.ndarray:
    """The tool's ``want``: the grid, step by step, in float32."""
    want = np.zeros((NT, 8, 128), np.float32)
    for t in range(NT):
        for c in range(nc):
            want[t] += np.float32(tab[c * 8, 0]) + np.float32(hbm[t * NCMAX + c, 0, 0])
    return want


def probe_dynamic_grid_plain(tab: torch.Tensor, hbm: torch.Tensor,
                             nc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``probe_dynamic_grid``, bit for bit: every
    chunk of the capacity, kept where ``c < nc`` (clamped to [0, NCMAX]), in
    the order c = 0, 1, ...; ``nc`` stays a tensor."""
    n = nc.clamp(0, NCMAX)
    rows = hbm.view(NT, NCMAX, 8 * 128)[:, :, 0].to(torch.float32)   # (NT, NCMAX)
    acc = torch.zeros((NT, 1, 1), dtype=torch.float32, device=tab.device)
    for c in range(NCMAX):
        step = (tab[c * 8, 0] + rows[:, c]).view(NT, 1, 1)
        acc = torch.where(c < n, acc + step, acc)
    return acc.expand(NT, 8, 128).contiguous()


def probe_dynamic_grid(tab: torch.Tensor, hbm: torch.Tensor,
                       nc: torch.Tensor) -> torch.Tensor:
    """Per tile t, the sum over chunks c < nc of ``tab[c * 8, 0] +
    float(hbm[t * NCMAX + c, 0, 0])``, in the order c = 0, 1, ...

    tab f32 (NCMAX * 8, 128); hbm i32 (NT * NCMAX, 8, 128); nc a 0-d int32
    tensor on the same device, clamped to [0, NCMAX] and never read by the
    host. Returns f32 (NT, 8, 128). CPU tensors take the plain version; CUDA
    tensors launch ``probe_dynamic_grid_kernel``, counted in
    ``probe_dynamic_grid.launches``; hbm must then start on 16 bytes (its
    rows' bulk copies).
    """
    dev = tab.device
    _probe.check(tab, "tab", torch.float32, (NCMAX * 8, 128), dev)
    _probe.check(hbm, "hbm", torch.int32, (NT * NCMAX, 8, 128), dev)
    _probe.check(nc, "nc", torch.int32, (), dev)
    if not _probe.kernel_device(probe_dynamic_grid, tab):
        return probe_dynamic_grid_plain(tab, hbm, nc)
    _probe.check_aligned(hbm, "hbm")
    out = torch.empty((NT, 8, 128), dtype=torch.float32, device=dev)
    P = _probe.P
    _probe.launch(probe_dynamic_grid, "probe_dynamic_grid", (P, P, P, P),
                  (tab.data_ptr(), hbm.data_ptr(), nc.data_ptr(),
                   out.data_ptr()), dev)
    return out


probe_dynamic_grid.launches = 0


def work(nc: int):
    """(bytes, lane operations) of a launch whose chunk count is ``nc``: nc
    itself, per tile nc hbm rows and nc tab words read, the output written
    once; OPS_PER_CHUNK per (tile, chunk, element)."""
    nbytes = 4 + NT * (nc * (8 * 128 * 4 + 4) + 8 * 128 * 4)
    return nbytes, OPS_PER_CHUNK * NT * nc * 8 * 128


def main(device: str = "cuda") -> dict:
    """Check the device-counted chunk loop against the tool's ``want`` for
    each chunk count and time it."""
    dev = resolve_device(device)
    print(f"torch {torch.__version__}, device {_probe.device_label(dev)}")
    tab, hbm = inputs(dev)
    host = (tab.cpu().numpy(), hbm.cpu().numpy())
    results = {}
    for nc in CHUNKS:
        count = torch.tensor(nc, dtype=torch.int32, device=dev)
        before = probe_dynamic_grid.launches
        got = probe_dynamic_grid(tab, hbm, count).cpu().numpy()
        want = expected(*host, nc)
        if not np.array_equal(got, want):
            raise RuntimeError(f"nc={nc}: WRONG, got[0,0,0]={got[0, 0, 0]} "
                               f"want={want[0, 0, 0]}")
        ms = _probe.time_ms(lambda: probe_dynamic_grid(tab, hbm, count), dev)
        results[nc] = {"ms": ms,
                       "launches": probe_dynamic_grid.launches - before}
        print(f"PASS  nc={nc}  got[0,0,0]={got[0, 0, 0]} want={want[0, 0, 0]}"
              f"  {ms * 1e3:.3f} us per call (the host's launch included)")
    print("ALL PASS")
    return results


if __name__ == "__main__":
    raise SystemExit(_probe.cli(main))
