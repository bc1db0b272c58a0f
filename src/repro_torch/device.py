"""Device policy for the port's entry points.

``Model``, ``DecodeEngine`` and ``Cluster`` run on CUDA unless the caller
asks for another device.  When no device is asked for and CUDA is absent
they raise: the port never carries on silently on the CPU, because a CPU
run says nothing about the card.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``.  Raises when CUDA is wanted and absent.

    On CUDA, float32 matrix products and convolutions are pinned to full
    float32 (no TF32): the port holds the reference's f32 tolerances."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU (its kernels then take their plain versions)"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
