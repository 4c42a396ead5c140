"""How a pytest run treats the test files that were in the repo before the
port, which stay as they are (ROADMAP.md, "Rules of the port"). Loaded by the
repo's root conftest.py; none of it changes what a test checks.

- Work units for pytest-xdist's ``--dist loadfile``. Under it a file runs whole
  on one worker, and tests/test_pallas.py alone takes over 2,000 s on one
  process. ``UNITS`` splits it into five units that run on different workers,
  and hands them out first, with the other slow files of the reference, longest
  first, in the order listed. Every other file stays one unit, handed out after
  them in pytest-xdist's own order (more tests first). Other ``--dist`` modes,
  and runs without xdist, are left as they are.
- Raised time limits (``TIME_LIMITS``, as the ``time_limit`` marker of
  tests/_time_limit.py) for the slow tests of those files.
- One native build at a time: every xdist worker runs tests/conftest.py's
  session fixture ``build_native`` (``make -C native``), so its setup holds an
  exclusive lock on native/.build.lock while the others wait.

pytest-xdist gives a worker its next unit once two tests of its current one
are left, and that unit then waits for them. So each unit runs its tests
longest first (the order of its names is the order they run in), and the
suite's wall time is about the longest unit's or the suite's time over the
workers, whichever is larger. The seconds noted are each unit's test time in
one run of the whole suite, six workers on an 8-core CPU host. A new slow test
goes into a unit that is not the longest, or into a unit of its own, placed in
this list by its time.
"""

import fcntl
import os

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNITS = (
    ("tests/test_pallas.py", (  # 606 s
        "test_pallas_texture_pages_with_slot_chunks",
        "test_triangle_prelive_is_conservative",
        "test_binning_covers_live_triangles",
        "test_bin_segments_partition_matches_touch_sets",
        "test_binning_partition_matches_stable_argsort")),
    ("tests/test_pallas.py", (  # 607 s
        "test_pallas_corners_ids_gid_base_offsets_globally",
        "test_pallas_multipass_spatial_matches_golden",
        "test_pallas_compact_early_bitexact_and_small_scene_path_unchanged",
        "test_pallas_segmented_matches_resident_bitexact",
        "test_pallas_non_tile_aligned_resolution")),
    ("tests/test_pallas.py", (  # 559 s
        "test_pallas_corners_ids_matches_compacted",
        "test_pallas_many_textures_pages",
        "test_pallas_multi_pass_untextured_scene",
        "test_pallas_render_batch",
        "test_pallas_many_textures_in_kernel")),
    ("tests/test_sharding.py", (  # 538 s, the whole file
        "test_triangle_sharded_10k_kernel_parity_bit_exact",
        "test_triangle_sharded_multipass_shards",
        "test_triangle_sharded_matches_single_device",
        "test_pallas_backend_sharded_segmented_scene",
        "test_pallas_backend_sharded_multitile_bands",
        "test_triangle_sharded_nonpow2_axis_fallback",
        "test_pallas_backend_sharded_matches_golden",
        "test_fb_sharded_matches_single_device",
        "test_frame_and_fb_sharded",
        "test_triangle_sharded_xla_matches_golden",
        "test_output_sharding_layout",
        "test_eight_devices_available",
        "test_indivisible_height_rejected",
        "test_pallas_backend_sharded_alignment_check")),
    ("tests/test_fuzz.py", (  # 418 s, the whole file
        "test_fuzz_golden_vs_pallas",
        "test_fuzz_bucketed_matches_exact",
        "test_batch_matches_singles_segmented",
        "test_fuzz_batch_matches_singles",
        "test_fuzz_golden_vs_pallas_segmented",
        "test_fuzz_golden_vs_device",
        "test_fuzz_golden_vs_native")),
    ("tests/test_pallas.py", (  # 282 s
        "test_adaptive_fetch_strip_rule_and_derived_legalization",
        "test_pallas_tile_h_216_matches_golden",
        "test_pallas_wide_span_strips_match_golden",
        "test_pallas_tile_h_128_matches_golden",
        "test_pallas_non_pow2_tile_h_matches_golden")),
    ("tests/test_pallas.py", (  # 212 s
        "test_pallas_matches_xla",
        "test_pallas_multi_pass_large_scene",
        "test_pallas_clipping_flight",
        "test_pallas_matches_golden_tetrahedron")),
    ("tests/test_bilinear.py", (  # 163 s, the whole file
        "test_pallas_bilinear_spatial_multipass",
        "test_backends_match_golden_bilinear",
        "test_pallas_bilinear_large_scene",
        "test_golden_bilinear_smoother_than_nearest",
        "test_sampler_blends_neighbors",
        "test_sampler_wraps")),
)

# About two and a half times the test's seconds alone on one process, at most
# 1200: 638 s, 371 s and 248 s.
TIME_LIMITS = {
    "tests/test_pallas.py::test_pallas_texture_pages_with_slot_chunks": 1200,
    "tests/test_pallas.py::test_pallas_corners_ids_matches_compacted": 925,
    "tests/test_pallas.py::test_pallas_corners_ids_gid_base_offsets_globally":
        620,
}


def _scope(i):
    """The scope (pytest-xdist's key of a work unit) of ``UNITS[i]``."""
    return f"{UNITS[i][0]}::unit{i}"


def _function(nodeid):
    """A node id's file and test function, without parameters."""
    path, _, rest = nodeid.partition("::")
    return path, rest.split("[", 1)[0]


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    scope_of = {(path, name): _scope(i)
                for i, (path, names) in enumerate(UNITS) for name in names}

    class ReferenceUnits(LoadFileScheduling):
        ordered = False

        def _split_scope(self, nodeid):
            return scope_of.get(_function(nodeid), super()._split_scope(nodeid))

        def _assign_work_unit(self, node):
            # The queue is complete by the first assignment: move the listed
            # units to its front, each in the order of its names.
            if not self.ordered:
                self.ordered = True
                for i in reversed(range(len(UNITS))):
                    scope, names = _scope(i), UNITS[i][1]
                    if scope in self.workqueue:
                        self.workqueue[scope] = dict(sorted(
                            self.workqueue[scope].items(),
                            key=lambda kv: names.index(_function(kv[0])[1])))
                        self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return ReferenceUnits(config, log)


def pytest_collection_modifyitems(items):
    for item in items:
        seconds = TIME_LIMITS.get("::".join(_function(item.nodeid)))
        if seconds is not None:
            item.add_marker(pytest.mark.time_limit(seconds))


@pytest.hookimpl(wrapper=True)
def pytest_fixture_setup(fixturedef, request):
    if fixturedef.argname != "build_native":
        return (yield)
    with open(os.path.join(_REPO, "native", ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return (yield)
