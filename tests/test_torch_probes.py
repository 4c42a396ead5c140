"""The port's probes (``swift3drenderer_tpu_torch.tools``) against the Mosaic
probes of the repo's ``tools/``, on CPU.

Each tool's own kernel body goes through ``pl.pallas_call(...,
interpret=True)`` with the tool's own specs (its ``build`` / ``run`` with
``pallas_call`` patched to interpret, or, for fetch_microbench, whose ``run``
returns only a time, its ``make_kernel`` with the specs of its ``run``), and
the port's plain version must equal it bit for bit: the outputs are integers,
and the dynamic grid sums small integers, exact in float32. The plain
versions visit each distinct iteration once; the tests hold them against the
literal loops too. The kernels themselves run only on a card
(tests/test_torch_cuda.py, chip_smoke.py phase 7).
"""

import functools
import importlib.util
import operator
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from swift3drenderer_tpu_torch import kernels
from swift3drenderer_tpu_torch.tools import _probe
from swift3drenderer_tpu_torch.tools import fetch_microbench as pfm
from swift3drenderer_tpu_torch.tools import probe_dynamic_grid as pdg
from swift3drenderer_tpu_torch.tools import probe_gather2d as pg2
from swift3drenderer_tpu_torch.tools import probe_packed_fetch as ppf
from swift3drenderer_tpu_torch.tools import probe_variants

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")


@functools.cache
def tool(name):
    """The repo's tools/<name>.py, loaded by path (tools is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_tpu_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    """Every pl.pallas_call in interpret mode, for the test's duration."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def host(*tensors):
    return [t.numpy() for t in tensors]


@pytest.mark.parametrize("iters", [3, 70])
@pytest.mark.parametrize("mode", pg2.MODES)
def test_gather2d_matches_pallas(interpret, mode, iters):
    atlas, rel, ln = pg2.inputs("cpu")[mode]
    got = pg2.probe_gather2d(mode, atlas, rel, ln, iters)
    want = np.asarray(tool("probe_gather2d").build(mode, iters)(*host(atlas, rel, ln)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mix,iters", [(0, 1), (127, 130)])
@pytest.mark.parametrize("mode", ppf.MODES)
def test_packed_fetch_matches_pallas(interpret, mode, mix, iters):
    data = ppf.inputs("cpu")
    blk, row, ln = data[mode]
    got = ppf.probe_packed_fetch(mode, blk, row, ln, mix, iters)
    want = np.asarray(tool("probe_packed_fetch").run(
        mode, *map(jnp.asarray, host(blk, row, ln)), mix=mix, iters=iters))
    np.testing.assert_array_equal(got.numpy(), want)
    if mode != "empty" and (mix, iters) == (0, 1):   # the tool's exact check
        assert torch.equal(got, data["want"])


@pytest.mark.parametrize("iters", [5, 70])
@pytest.mark.parametrize("mode", pfm.MODES)
def test_fetch_microbench_matches_pallas(monkeypatch, mode, iters):
    tpu = tool("fetch_microbench")
    monkeypatch.setattr(tpu, "ITERS", iters)
    atlas, key, ln = pfm.inputs("cpu")
    got = pfm.fetch_microbench(mode, atlas, key, ln, iters)
    # The specs of the tool's run(), which returns only a time.
    want = pl.pallas_call(
        tpu.make_kernel(mode),
        out_shape=jax.ShapeDtypeStruct((tpu.SPH, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(*map(jnp.asarray, host(atlas, key, ln)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nc", pdg.CHUNKS)
def test_dynamic_grid_matches_pallas(interpret, nc):
    tpu = tool("probe_dynamic_grid")
    tab, hbm = pdg.inputs("cpu")
    got = pdg.probe_dynamic_grid(tab, hbm, torch.tensor(nc, dtype=torch.int32))
    # The tool's run is jax.jit-ted: nc is traced, so the grid is dynamic.
    want = np.asarray(tpu.run(*map(jnp.asarray, host(tab, hbm)), nc))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pdg.expected(*host(tab, hbm), nc))


# The plain versions' distinct-iteration shortcuts against the literal loops,
# at counts that are not multiples of the period (64 blocks, 128 lanes).
LITERAL_ITERS = (0, 1, 63, 200)


@pytest.mark.parametrize("mode", pg2.MODES)
def test_gather2d_plain_equals_literal_loop(mode):
    atlas, rel, ln = pg2.inputs("cpu")[mode]
    for iters in LITERAL_ITERS:
        np.testing.assert_array_equal(
            pg2.probe_gather2d_plain(mode, atlas, rel, ln, iters).numpy(),
            pg2.expected(mode, *host(atlas, rel, ln), iters), err_msg=str(iters))


@pytest.mark.parametrize("mode", ppf.MODES)
def test_packed_fetch_plain_equals_literal_loop(mode):
    blk, row, ln = ppf.inputs("cpu")[mode]
    for mix in (0, 5, 127):
        for iters in LITERAL_ITERS:
            np.testing.assert_array_equal(
                ppf.probe_packed_fetch_plain(mode, blk, row, ln, mix, iters).numpy(),
                ppf.expected(mode, *host(blk, row, ln), mix, iters),
                err_msg=f"mix={mix} iters={iters}")


@pytest.mark.parametrize("mode", pfm.MODES)
def test_fetch_microbench_plain_equals_literal_loop(mode):
    atlas, key, ln = pfm.inputs("cpu")
    # The tool's keys, and keys that match only past block 63 or never.
    rng = np.random.default_rng(1)
    wide = torch.from_numpy(rng.integers(-8, 2000, key.shape).astype(np.int32))
    for k in (key, wide):
        for iters in LITERAL_ITERS:
            np.testing.assert_array_equal(
                pfm.fetch_microbench_plain(mode, atlas, k, ln, iters).numpy(),
                pfm.expected(mode, *host(atlas, k, ln), iters),
                err_msg=str(iters))


# The card's chunk plan (tools/_probe.py chunk_plan, csrc/probes.cu
# fold_chunk): each chunk folded as the kernels' L1 path folds it (UNROLL
# accumulators, then the ragged rest), the partials folded into a zeroed
# output, must give the oracle's loop. The counts straddle the period (64) and the chunk
# length at small counts (MIN_CHUNK), on the H100's 132 SMs.
PLAN_ITERS = (0, 1, 3, 63, 64, 65, 130, _probe.MIN_CHUNK - 1,
              _probe.MIN_CHUNK, _probe.MIN_CHUNK + 1,
              2 * _probe.MIN_CHUNK + 3)
PLAN_SMS = 132


def gather2d_body(mode, atlas, rel, ln):
    """probe_gather2d's iteration ``it``: the texel from block it % 64."""
    lane = np.arange(128)
    if mode in ("base8", "sub8"):
        blocks = atlas.reshape(pg2.NBLK, 8, 128)
        return lambda it: blocks[it % pg2.NBLK][rel, lane if mode == "sub8" else ln]
    shift = 9 if mode == "ta4096" else 7
    return lambda it: atlas[it % pg2.NBLK][(rel << shift) | ln]


def fetch_body(mode, atlas, key, ln):
    """fetch_microbench's iteration ``b``: the mode's part of the fetch body
    over block b % 64, as the kernel computes it."""
    lane = np.arange(128)

    def body(b):
        if mode == "empty":
            return np.full(key.shape, b, np.int32)
        block = atlas[(b % 64) * 8: (b % 64) * 8 + 8, :128]
        if mode == "loadonly":
            return np.broadcast_to(block[0][lane], key.shape)
        acc = np.zeros(key.shape, np.int32)
        for r in range(8):
            g = (np.full(key.shape, 7, np.int32) if mode == "noload"
                 else block[r][lane] if mode == "nogather" else block[r][ln])
            acc |= g if mode == "noselect" else np.where(key == b * 8 + r, g, 0)
        return acc
    return body


def packed_fetch_body(mode, blk, row, ln, mix):
    """probe_packed_fetch's iteration ``it`` (the global counter): the texel
    at lane (ln + (it & mix)) & 127 of the block."""
    return lambda it: ppf._body(mode, blk, row, (ln + (it & mix)) & 127)


@pytest.mark.parametrize("probe,mode", [("gather2d", m) for m in pg2.MODES]
                         + [("fetch_microbench", m) for m in pfm.MODES]
                         + [("packed_fetch", m) for m in ppf.MODES])
def test_chunk_plan_folds_to_the_oracle(probe, mode):
    if probe == "gather2d":
        atlas, rel, ln = host(*pg2.inputs("cpu")[mode])
        folds = [(gather2d_body(mode, atlas, rel, ln), np.bitwise_xor,
                  functools.partial(pg2.expected, mode, atlas, rel, ln))]
        rows, full = pg2.SPH, pg2.ITERS
    elif probe == "fetch_microbench":
        atlas, key, ln = host(*pfm.inputs("cpu"))
        folds = [(fetch_body(mode, atlas, key, ln), np.bitwise_or,
                  functools.partial(pfm.expected, mode, atlas, key, ln))]
        rows, full = pfm.SPH, pfm.ITERS
    else:   # at the correctness check's mix and the timed one
        blk, row, ln = host(*ppf.inputs("cpu")[mode])
        folds = [(packed_fetch_body(mode, blk, row, ln, mix), np.bitwise_or,
                  lambda iters, mix=mix: ppf.expected(mode, blk, row, ln, mix,
                                                      iters))
                 for mix in (0, ppf.TIMED_MIX)]
        rows, full = ppf.SPH, ppf.ITERS
    for body, op, oracle in folds:
        fold_chunks(body, op, oracle, rows)
    # At the tool's full count the plan fills the card: WAVES waves of
    # RESIDENT blocks an SM, give or take one chunk a row.
    chunks, chunk = _probe.chunk_plan(full, rows, PLAN_SMS)
    assert (chunks - 1) * chunk < full <= chunks * chunk
    assert abs(chunks * rows - PLAN_SMS * _probe.RESIDENT * _probe.WAVES) <= rows


def fold_chunks(body, op, oracle, rows):
    """Fold ``body`` over the chunks of the plan at each of PLAN_ITERS as
    fold_chunk does and hold the result to ``oracle(iters)``."""
    for iters in PLAN_ITERS:
        chunks, chunk = _probe.chunk_plan(iters, rows, PLAN_SMS)
        assert chunk % _probe.UNROLL == 0 and chunk >= _probe.MIN_CHUNK
        assert (chunks - 1) * chunk < iters <= chunks * chunk or iters == chunks == 0
        out = np.zeros((rows, 128), np.int32)
        for k in range(max(chunks, 1)):   # an empty call still runs one chunk
            lo = k * chunk
            hi = lo + max(0, min(chunk, iters - lo))
            acc = [np.zeros((rows, 128), np.int32) for _ in range(_probe.UNROLL)]
            it = lo
            while hi - it >= _probe.UNROLL:
                for j in range(_probe.UNROLL):
                    acc[j] = op(acc[j], body(it + j))
                it += _probe.UNROLL
            for it in range(it, hi):
                acc[0] = op(acc[0], body(it))
            out = op(out, functools.reduce(op, acc))
        np.testing.assert_array_equal(out, oracle(iters), err_msg=str(iters))


@pytest.mark.parametrize("name", list(probe_variants.VARIANTS))
def test_probe_variant_rewrites_one_line(name):
    """Each build variant of tools/probe_variants.py finds the default's line
    in csrc/probes.cu once and changes that line alone."""
    with open(os.path.join(kernels.CSRC, kernels.PROBES)) as f:
        src = f.read().splitlines()
    got = probe_variants.variant_source(name).splitlines()
    old, new = probe_variants.VARIANTS[name]
    assert len(got) == len(src)
    assert [(a, b) for a, b in zip(src, got) if a != b] == [(old, new)]


def test_probe_constants_are_the_kernels():
    """The chunk plan's UNROLL is csrc/probes.cu's kUnroll, and the staged
    gather's STAGED_PIXELS and STAGE_BYTES (from which the load count of its
    loop is checked) are its kPixels and kStageBytes."""
    with open(os.path.join(kernels.CSRC, kernels.PROBES)) as f:
        src = f.read()
    consts = {}
    for name, value in re.findall(r"constexpr int (k\w+) = ([\d *]+);", src):
        factors = [int(v) for v in value.split("*")]
        consts[name] = functools.reduce(operator.mul, factors)
    assert consts["kUnroll"] == _probe.UNROLL
    assert consts["kPixels"] == pg2.STAGED_PIXELS
    assert consts["kStageBytes"] == pg2.STAGE_BYTES
    # The dynamic grid's tiles and chunk capacity (the kernel's grid and its
    # buffer of kNCMax row slots).
    assert consts["kNT"] == pdg.NT
    assert consts["kNCMax"] == pdg.NCMAX
    assert consts["kLanes"] == 128


@pytest.mark.parametrize("words,lines,banks", [
    (torch.arange(32), 1, 1),                 # one 128-byte line, a word a bank
    (torch.arange(32) * 32, 32, 32),          # a line each, all in bank 0
    (torch.zeros(32, dtype=torch.long), 1, 1),   # one word, broadcast
    (torch.arange(64).reshape(2, 32) * 2, 4, 4),   # two warps, stride 2
])
def test_wavefront_counts(words, lines, banks):
    assert _probe.distinct_lines(words) == lines
    assert _probe.bank_wavefronts(words) == banks


def test_load_words_are_the_kernels_offsets():
    """Each mode's per-load word offsets: base8 eight rows at ln, sub8 (rel,
    own lane), ta* (rel << 7 or 9) | ln; fetch_microbench's rows of a
    512-wide atlas at ln or the own lane; none for noload and empty."""
    _, rel, ln = pg2.inputs("cpu")["base8"]
    lane = torch.arange(128).expand(16, 128)
    words = pg2.load_words("base8", rel, ln)
    assert len(words) == 8 and torch.equal(words[3], 3 * 128 + ln.long())
    assert torch.equal(pg2.load_words("sub8", rel, ln)[0], rel.long() * 128 + lane)
    _, rel, ln = pg2.inputs("cpu")["ta4096"]
    assert torch.equal(pg2.load_words("ta4096", rel, ln)[0],
                       (rel.long() << 9) | ln.long())
    _, key, ln = pfm.inputs("cpu")
    for mode in pfm.MODES:
        got = pfm.load_words(mode, ln)
        assert len(got) == pfm.ROWS_READ[mode]
    assert torch.equal(pfm.load_words("full", ln)[7], 7 * 512 + ln.long())
    assert torch.equal(pfm.load_words("loadonly", ln)[0],
                       torch.arange(128).expand(32, 128))


@pytest.mark.parametrize("shift", [0, 1, 77, 127])
def test_packed_fetch_load_words_are_the_kernels_offsets(shift):
    """probe_packed_fetch's loads at lane shift ``it & mix``: row r at
    ``(ln + shift) & 127`` (``r * 128 + ln0`` in the block), rows 0-7 for
    gather8, 0-5 for the packed modes, none for empty."""
    for mode in ppf.MODES:
        _, _, ln = ppf.inputs("cpu")[mode]
        ln0 = (ln.long() + shift) & 127
        got = ppf.load_words(mode, ln, shift)
        rows = {"gather8": 8, "packed4": 6, "packed4sel": 6, "empty": 0}[mode]
        assert len(got) == rows
        for r, words in enumerate(got):
            assert torch.equal(words, r * 128 + ln0), (mode, r)


def test_bank_wavefronts_match_a_warp_by_warp_count():
    """The vectorised count equals the count taken warp by warp: for each
    warp-wide load, the most distinct words one bank serves."""
    words = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1024, (64, 32))).long()
    want = sum(int(torch.bincount(w.unique() % 32, minlength=32).max())
               for w in words)
    assert _probe.bank_wavefronts(words) == want


def test_check_aligned_refuses_a_misaligned_start():
    """The bulk copies need a 16-byte start: the check reads the address
    alone."""
    base = torch.zeros(2048, dtype=torch.int32)
    _probe.check_aligned(base[:1024], "blk")
    _probe.check_aligned(base[4:1028], "blk")
    with pytest.raises(ValueError, match="16 bytes"):
        _probe.check_aligned(base[1:1025], "blk")


def test_dynamic_grid_plain_clamps_the_count():
    tab, hbm = pdg.inputs("cpu")
    for nc, clamped in ((0, 0), (-3, 0), (7, pdg.NCMAX)):
        got = pdg.probe_dynamic_grid_plain(tab, hbm, torch.tensor(nc, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), pdg.expected(*host(tab, hbm), clamped))


def test_oracles_and_layouts_are_the_tools():
    g2 = tool("probe_gather2d")
    rng_tool, rng_port = np.random.default_rng(4), np.random.default_rng(4)
    rel = rng_tool.integers(0, 8, size=(16, 128)).astype(np.int32)
    lx = rng_tool.integers(0, 512, size=(16, 128)).astype(np.int32)
    rng_port.integers(0, 8, size=(16, 128))
    rng_port.integers(0, 512, size=(16, 128))
    for mode in pg2.MODES:
        atlas = g2.atlas_for(mode, rng_tool)
        np.testing.assert_array_equal(pg2.atlas_for(mode, rng_port), atlas)
        ln = lx if mode == "ta4096" else lx & 127
        np.testing.assert_array_equal(pg2.expected(mode, atlas, rel, ln, 70),
                                      g2.expected(mode, atlas, rel, ln, 70))
    block = np.random.default_rng(5).integers(0, 2 ** 24, (8, 128)).astype(np.int32)
    np.testing.assert_array_equal(ppf.pack_block(block),
                                  tool("probe_packed_fetch").pack_block(block))


@pytest.mark.parametrize("module", [pg2, ppf, pfm, pdg], ids=lambda m: m.__name__.split(".")[-1])
def test_main_runs_on_cpu_and_refuses_cuda_without_a_card(module, monkeypatch):
    results = module.main("cpu")
    modes = getattr(module, "MODES", getattr(module, "CHUNKS", None))
    assert sorted(map(str, results)) == sorted(map(str, modes))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.inputs("cuda")


def test_wrappers_check_their_inputs():
    atlas, rel, ln = pg2.inputs("cpu")["base8"]
    with pytest.raises(ValueError):
        pg2.probe_gather2d("gather9", atlas, rel, ln, 3)
    with pytest.raises(ValueError, match="shape"):
        pg2.probe_gather2d("ta1024", atlas, rel, ln, 3)
    with pytest.raises(ValueError, match="iters"):
        pg2.probe_gather2d("base8", atlas, rel, ln, -1)
    blk, row, ln = ppf.inputs("cpu")["gather8"]
    with pytest.raises(ValueError, match="mix"):
        ppf.probe_packed_fetch("gather8", blk, row, ln, mix=128)
    with pytest.raises(ValueError, match="int32"):
        ppf.probe_packed_fetch("gather8", blk.float(), row, ln)
    atlas, key, ln = pfm.inputs("cpu")
    with pytest.raises(ValueError, match="iters"):
        pfm.fetch_microbench("full", atlas, key, ln, 2 ** 28)
    tab, hbm = pdg.inputs("cpu")
    with pytest.raises(ValueError, match="shape"):
        pdg.probe_dynamic_grid(tab, hbm, torch.tensor([2], dtype=torch.int32))
    # Neither cpu nor cuda: no kernel and no plain version.
    meta = [t.to("meta") for t in (tab, hbm)]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        pdg.probe_dynamic_grid(*meta, torch.tensor(2, dtype=torch.int32, device="meta"))
