"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU; there
is no silent CPU fallback.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means ``"cuda"``; under a process group a CUDA device without
    an index is this rank's card, ``cuda:LOCAL_RANK`` (0 where unset).
    Raises `RuntimeError` when a CUDA device is asked for (or implied) and
    CUDA is not available; ``"cpu"`` always works."""
    dev = torch.device("cuda" if device is None else device)
    if (dev.type == "cuda" and dev.index is None
            and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (plain PyTorch versions of its kernels)")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def no_tf32():
    """cuDNN's flags as they are, with TF32 off: the scorers' float32
    numerics on the card (the matmul flag stays at its default, off)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


_SMS = {}


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (the kernels' launch
    plans size their grids by it), read once a device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]
