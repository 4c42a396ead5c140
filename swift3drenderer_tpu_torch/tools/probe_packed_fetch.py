"""Counterpart of the repo's ``tools/probe_packed_fetch.py``: the
packed-channel quad-row texel fetch against the 8-gather body.

``pack_block`` repacks an (8, 128) RGB block into per-channel quad-row words
``[R0 R1 G0 G1 B0 B1 0 0]`` (word [2c + j] packs rows 4j..4j+3 of channel c,
little-endian by row). Every pixel of a (16, 128) strip OR-accumulates, over
``iters`` iterations, a texel at lane ``(ln + (it & mix)) & 127`` of one
block:

  gather8     eight row loads and the 3-level select tree on ``row``;
  packed4     six loads (two a channel) into the packed block, the quad word
              picked per pixel, then its byte by a variable shift;
  packed4sel  the same with a select tree in place of the shift;
  empty       the loop's cost: the lane index alone.

At ``mix = 0, iters = 1`` the three fetches give ``block[row, ln]``; at
``mix = 127`` the lane varies with the loop counter, so the body cannot be
hoisted (the timed setting). Kernel: ``csrc/probes.cu``: gather8 reads a
copy of the block in shared memory that each block of the grid makes once
(``probe_packed_fetch_staged_kernel``; on the TPU the block sits in VMEM),
the packed modes read it through L1 and empty has no load
(``probe_packed_fetch_kernel``): each mode's faster build on the H100.
The card runs the iteration axis in chunks on every SM at once
(``_probe.chunk_plan``) and ORs the partials, so ns an iteration (the
launch's ms over ``ITERS``, as the TPU tool prints it) is the whole strip's
cost an iteration at full occupancy, not one thread's latency.

    python -m swift3drenderer_tpu_torch.tools.probe_packed_fetch [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import resolve_device
from . import _probe

SPH = 16
ITERS = 200000
TIMED_MIX = 127
MODES = ("gather8", "packed4", "packed4sel", "empty")
CHECKS = ((0, 1), (TIMED_MIX, 130))   # (mix, iters) held against the oracle
# Lane operations of one pixel-iteration, counted from the kernel's source:
# one per load, ALU op and select, two for the loop counter; the lane index
# takes 3. gather8: eight loads, the tree's 3 tests and 7 selects, the OR.
# packed4: per channel two loads, the quad select, shift and mask, shift and
# OR into the word (7), and the OR. packed4sel: per channel two loads, the
# quad select, two tests, two shifts, two selects, the mask, shift and OR
# (12), and the OR. empty: the OR.
OPS_PER_ITER = {"gather8": 24, "packed4": 27, "packed4sel": 42, "empty": 6}
BLOCK_ROWS_READ = {"gather8": 8, "packed4": 6, "packed4sel": 6, "empty": 0}


def pack_block(block: np.ndarray) -> np.ndarray:
    """(8, 128) i32 RGB block -> (8, 128) i32 [R0 R1 G0 G1 B0 B1 0 0]."""
    out = np.zeros_like(block)
    for ch, sh in enumerate((16, 8, 0)):
        u8 = ((block >> sh) & 0xFF).astype(np.uint32)   # (8, 128)
        for j in range(2):                              # quad-row words
            rows = u8[4 * j: 4 * j + 4]
            w = (rows[0] | (rows[1] << np.uint32(8))
                 | (rows[2] << np.uint32(16)) | (rows[3] << np.uint32(24)))
            out[2 * ch + j] = w.view(np.int32)
    return out


def _body(mode: str, blk, row, ln0):
    """One iteration's value for every pixel, at lane indices ``ln0`` (numpy
    or torch, any leading axes): the TPU kernel's body."""
    if mode == "empty":
        return ln0
    if mode == "gather8":
        g = [blk[r][ln0] for r in range(8)]
        b0, b1, b2 = (row & 1) != 0, (row & 2) != 0, (row & 4) != 0
        where = np.where if isinstance(ln0, np.ndarray) else torch.where
        s0 = [where(b0, g[i + 1], g[i]) for i in (0, 2, 4, 6)]
        s1 = [where(b1, s0[i + 1], s0[i]) for i in (0, 2)]
        return where(b2, s1[1], s1[0])
    where = np.where if isinstance(ln0, np.ndarray) else torch.where
    q, sh8 = (row & 4) != 0, (row & 3) << 3
    packed = 0
    for ch, sh in ((0, 16), (1, 8), (2, 0)):
        g = where(q, blk[2 * ch + 1][ln0], blk[2 * ch][ln0])
        if mode == "packed4":
            byte = (g >> sh8) & 0xFF
        else:
            b0 = where((row & 1) != 0, g >> 8, g)
            byte = where((row & 2) != 0, b0 >> 16, b0) & 0xFF
        packed = packed | (byte << sh)
    return packed


def expected(mode: str, blk: np.ndarray, row, ln, mix: int,
             iters: int) -> np.ndarray:
    """Numpy oracle: the TPU kernel's loop, iteration by iteration."""
    acc = np.zeros((SPH, 128), np.int32)
    for b in range(iters):
        acc |= _body(mode, blk, row, (ln + (b & mix)) & 127)
    return acc


def inputs(device) -> dict:
    """Each mode's (block, row, ln) on ``device``: the tool's block, row and
    ln drawn from ``default_rng(0)`` in its order; the packed modes take
    ``pack_block(block)``. Also ``"want"``: ``block[row, ln]``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    block = rng.integers(0, 2 ** 24, (8, 128)).astype(np.int32)
    row = rng.integers(0, 8, (SPH, 128)).astype(np.int32)
    ln = rng.integers(0, 128, (SPH, 128)).astype(np.int32)
    packed = pack_block(block)

    def t(a):
        return torch.from_numpy(a).to(dev)

    out = {mode: (t(packed if mode.startswith("packed") else block), t(row),
                  t(ln)) for mode in MODES}
    out["want"] = t(block[row, ln])
    return out


def probe_packed_fetch_plain(mode: str, blk: torch.Tensor, row: torch.Tensor,
                             ln: torch.Tensor, mix: int,
                             iters: int) -> torch.Tensor:
    """Plain PyTorch version of ``probe_packed_fetch``, bit for bit. OR is
    idempotent and an iteration depends on ``it`` only through ``it & mix``,
    which repeats with period ``2 ** mix.bit_length()``, so it visits each
    distinct ``it & mix`` once. ``expected``, the literal loop, gives the
    same answer."""
    period = 1 << mix.bit_length()
    steps = sorted({b & mix for b in range(min(iters, period))})
    if not steps:
        return torch.zeros((SPH, 128), dtype=torch.int32, device=blk.device)
    d = torch.tensor(steps, dtype=torch.int32, device=blk.device)
    ln0 = ((ln[None] + d[:, None, None]) & 127).long()   # (n, SPH, 128)
    vals = _body(mode, blk, row, ln0)
    return _probe.fold(vals.to(torch.int32), torch.bitwise_or)


def probe_packed_fetch(mode: str, blk: torch.Tensor, row: torch.Tensor,
                       ln: torch.Tensor, mix: int = 0,
                       iters: int = 1) -> torch.Tensor:
    """OR over ``iters`` iterations of one texel per pixel at lane
    ``(ln + (it & mix)) & 127`` of ``blk``, fetched by ``mode``'s pattern.

    blk int32 (8, 128) (``pack_block``'s layout for the packed modes); row
    int32 (16, 128) in [0, 8) and ln int32 (16, 128) in [0, 128), not checked
    on the card (a host read); mix in [0, 127]. Returns int32 (16, 128). CPU
    tensors take the plain version; CUDA tensors launch
    ``probe_packed_fetch_staged_kernel<mode>`` (gather8) or
    ``probe_packed_fetch_kernel<mode>`` (the others) over the chunks of
    ``_probe.chunk_plan``, counted in ``probe_packed_fetch.launches``; blk
    must then start on 16 bytes (gather8's bulk copy of it).
    """
    m = MODES.index(mode)
    dev = row.device
    _probe.check(blk, "blk", torch.int32, (8, 128), dev)
    for t, name in ((row, "row"), (ln, "ln")):
        _probe.check(t, name, torch.int32, (SPH, 128), dev)
    if not 0 <= mix <= 127:
        raise ValueError(f"mix must be in [0, 127], got {mix}")
    _probe.check_iters(iters)
    if not _probe.kernel_device(probe_packed_fetch, row):
        return probe_packed_fetch_plain(mode, blk, row, ln, mix, iters)
    _probe.check_aligned(blk, "blk")
    chunks, chunk = _probe.chunk_plan(iters, SPH, _probe.sm_count(dev.index))
    out = torch.empty((SPH, 128), dtype=torch.int32, device=dev)
    P, I = _probe.P, _probe.I
    _probe.launch(probe_packed_fetch, "probe_packed_fetch",
                  (I, P, P, P, P, I, I, I, I, I),
                  (m, blk.data_ptr(), row.data_ptr(), ln.data_ptr(),
                   out.data_ptr(), SPH, mix, iters, chunks, chunk), dev)
    return out


probe_packed_fetch.launches = 0


def work(mode: str, row: torch.Tensor, iters: int):
    """(bytes, lane operations) the probe needs: the block rows it reads,
    row and ln read once, the output written once; OPS_PER_ITER per
    pixel-iteration."""
    nbytes = BLOCK_ROWS_READ[mode] * 128 * 4 + 3 * row.numel() * 4
    return nbytes, OPS_PER_ITER[mode] * row.numel() * iters


def load_words(mode: str, ln: torch.Tensor, shift: int = 0) -> list:
    """The word offsets within the block that each of an iteration's loads
    reads when ``it & mix`` is ``shift``, (16, 128) a load: row r at lane
    ``(ln + shift) & 127``, rows 0-7 for gather8, 0-5 (two a channel) for
    the packed modes, none for empty. The access pattern that L1 or shared
    memory sees."""
    ln0 = (ln.long().cpu() + shift) & 127
    return [r * 128 + ln0 for r in range(BLOCK_ROWS_READ[mode])]


def main(device: str = "cuda") -> dict:
    """Check every packed-fetch mode against the oracle and time it at
    mix = 127."""
    dev = resolve_device(device)
    print(f"torch {torch.__version__}, device {_probe.device_label(dev)}")
    data = inputs(dev)
    results = {}
    for mode in ("empty",) + MODES[:-1]:   # the tool's timing order
        blk, row, ln = data[mode]
        before = probe_packed_fetch.launches
        host = [t.cpu().numpy() for t in (blk, row, ln)]
        for mix, iters in CHECKS:
            got = probe_packed_fetch(mode, blk, row, ln, mix, iters)
            want = expected(mode, *host, mix, iters)
            if not np.array_equal(got.cpu().numpy(), want):
                raise RuntimeError(f"{mode}: WRONG at mix={mix}, iters={iters}")
        if mode != "empty" and not torch.equal(
                probe_packed_fetch(mode, blk, row, ln), data["want"]):
            raise RuntimeError(f"{mode}: not block[row, ln] at mix=0, iters=1")
        print(f"PASS  exact[{mode}]")
        ms = _probe.time_ms(lambda: probe_packed_fetch(
            mode, blk, row, ln, TIMED_MIX, ITERS), dev)
        ns = ms / ITERS * 1e6
        net = ns - results["empty"]["ns_per_iter"] if mode != "empty" else 0.0
        results[mode] = {"ms": ms, "ns_per_iter": ns, "net_ns_per_iter": net,
                         "launches": probe_packed_fetch.launches - before}
        print(f"  {mode:11s} {ns:8.3f} ns/iter"
              + (f"  (net {net:.3f})" if mode != "empty" else ""))
    print("ALL PASS")
    return results


if __name__ == "__main__":
    raise SystemExit(_probe.cli(main))
