"""The port's counterparts of the repo's ``examples/`` scripts, each with a
``main(argv)``: ``python -m swift3drenderer_tpu_torch.examples.<name>``."""
