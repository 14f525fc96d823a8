"""Device and precision policy of the port — the one place it lives.

Precision: the reference runs its small convolutions (`_conv1d_axis`,
`_conv3d_zero`) at `Precision.HIGHEST` (ipp_tpu/ops/deconv.py:90,150,424),
so TF32 is switched off for both cuBLAS matmuls and cuDNN convolutions.

Device: CUDA, or the CPU only when IPP_TPU_PLATFORM=cpu is set (the
variable the JAX CLIs already honour).  With neither, resolution raises:
the port never carries on silently on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["apply_precision_policy", "resolve_device"]


def apply_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device to run on: `device` when given, else the CPU if
    IPP_TPU_PLATFORM=cpu, else the current CUDA device.  Raises when no
    CUDA device is present and the CPU was not asked for."""
    if device is not None:
        return torch.device(device)
    if os.environ.get("IPP_TPU_PLATFORM", "").lower() == "cpu":
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(
        "no CUDA device is available; set IPP_TPU_PLATFORM=cpu to run the "
        "port on the CPU (plain PyTorch versions of every kernel)")
