"""The port's counterparts of the repo's ``tools/``.

The probes: each mirrors one TPU probe: a hand-written CUDA kernel in
``csrc/probes.cu`` behind a wrapper (CUDA tensors launch the kernel, CPU
tensors take the plain PyTorch version), a launch counter on the wrapper, the
tool's numpy oracle, and ``main(device="cuda")``, which draws the tool's
inputs, checks every mode against the oracle, times it and prints one line
per mode as the tool does:

    python -m swift3drenderer_tpu_torch.tools.probe_gather2d [--device cpu]
    python -m swift3drenderer_tpu_torch.tools.probe_packed_fetch
    python -m swift3drenderer_tpu_torch.tools.fetch_microbench
    python -m swift3drenderer_tpu_torch.tools.probe_dynamic_grid

A mode that fails raises: nothing is caught, and nothing falls back.

``validate`` is the counterpart of ``tools/tpu_validate.py``: its 22 cases
and its fuzz draws through the port's paths, each held to the golden oracle
and, on the card, to the CPU's frame bit for bit
(``python -m swift3drenderer_tpu_torch.tools.validate [--device cpu]
[--fuzz N] [--no-100k]``).

``perf_probe`` and ``stress_probe`` are the counterparts of the repo's
``tools/perf_probe.py`` and ``tools/stress_probe.py``: a frame's time split
into its stages (front-end, binning, the raster kernel's timing forms
``phases="vis"`` and ``"shade"``, the full frame), each stage a CUDA graph
replayed over bench.py's flight on the card
(``python -m swift3drenderer_tpu_torch.tools.perf_probe [--device cpu]``,
``python -m swift3drenderer_tpu_torch.tools.stress_probe [--device cpu]``).

``native_baseline`` is the counterpart of ``tools/native_baseline.py``: the
native C++ core (``swift3drenderer_tpu_torch.native``, built at first use)
at the baseline configs, against the reference C++ core's results
(``python -m swift3drenderer_tpu_torch.tools.native_baseline
[--frames-scale S]``).

``seg_variants`` is a measurement of the port's own: builds of the raster
kernels (segmented and flat) with one constant changed, timed against the
default build on the card
(``python -m swift3drenderer_tpu_torch.tools.seg_variants``).
"""
