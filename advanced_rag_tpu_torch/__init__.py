"""advanced_rag_tpu_torch: the PyTorch and CUDA port of advanced_rag_tpu.

The package mirrors the JAX package's module paths (``ops/dense.py`` here
is the counterpart of ``advanced_rag_tpu/ops/dense.py``) and never imports
JAX or the JAX package.  Every entry point takes a ``device``: it runs on
the CUDA card unless the caller passes ``device="cpu"``, and it raises when
no card is present rather than moving to the CPU.

Hand-written CUDA kernels live in ``csrc/`` and are built by ``_build.py``
on first use; each kernel module keeps a plain PyTorch version of the same
function, which serves CPU tensors and is what the kernels are tested
against.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card.  Without a card that raises: a caller who
    wants the CPU says ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "advanced_rag_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


__all__ = ["resolve_device", "DeviceLike", "__version__"]
