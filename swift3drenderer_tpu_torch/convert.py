"""Device placement, and conversion from the JAX package's device arrays.

``device_arrays_from_numpy`` takes the dict that
``swift3drenderer_tpu.renderer.scene_to_device`` returns, with every value
turned into numpy (``np.asarray``), and gives the dict the port's
``renderer.scene_to_device`` builds. The tests render both packages from
identical arrays this way; the port itself never imports the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA device must be present — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to render "
            "with the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_arrays_from_numpy(dev_np: Dict[str, np.ndarray],
                             device) -> Dict[str, torch.Tensor]:
    """The port's device dict (textures, vert_c, norm_c, attr_c, tex_c) from
    numpy arrays of the same keys; other keys (the JAX dict's topology
    ``vi``/``ai``) are dropped. Atlas words travel as int32 (they are below
    2^24), tex ids as int32."""
    dev = resolve_device(device)
    textures = np.ascontiguousarray(dev_np["textures"], np.uint32)
    out = {
        "textures": torch.tensor(textures.view(np.int32)),
        "tex_c": torch.tensor(np.asarray(dev_np["tex_c"], np.int32)),
    }
    for k in ("vert_c", "norm_c", "attr_c"):
        out[k] = torch.tensor(np.asarray(dev_np[k], np.float32))
    return {k: v.to(dev) for k, v in out.items()}
