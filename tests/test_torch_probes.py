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
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from swift3drenderer_tpu_torch.tools import fetch_microbench as pfm
from swift3drenderer_tpu_torch.tools import probe_dynamic_grid as pdg
from swift3drenderer_tpu_torch.tools import probe_gather2d as pg2
from swift3drenderer_tpu_torch.tools import probe_packed_fetch as ppf

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
