"""The port's counterparts of the Mosaic probes in the repo's ``tools/``.

Each module mirrors one TPU probe: a hand-written CUDA kernel in
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

``seg_variants`` is a measurement of the port's own: builds of the segmented
raster kernels with one constant changed, timed against the default build on
the card (``python -m swift3drenderer_tpu_torch.tools.seg_variants``).
"""
