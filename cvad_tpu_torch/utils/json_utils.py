"""numpy/torch -> JSON serialization.

An own copy of `cvad_tpu/utils/json_utils.py` (``safe_json_save``,
``safe_json_load``, ``convert_to_json_serializable``) that converts torch
tensors where `cvad_tpu`'s converts JAX arrays.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch


def convert_to_json_serializable(obj: Any) -> Any:
    """Recursively convert numpy/torch scalars and arrays to Python
    natives."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return convert_to_json_serializable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): convert_to_json_serializable(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [convert_to_json_serializable(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


def safe_json_save(data: Any, filepath, verbose: bool = True) -> bool:
    """Serialize `data` to JSON at `filepath`, creating parent directories.
    Returns True on success, False (and prints when `verbose`) on failure."""
    try:
        filepath = Path(filepath)
        filepath.parent.mkdir(parents=True, exist_ok=True)
        with open(filepath, "w") as f:
            json.dump(convert_to_json_serializable(data), f, indent=2)
        if verbose:
            print(f"saved JSON: {filepath}")
        return True
    except Exception as e:  # noqa: BLE001 — the contract is a bool
        if verbose:
            print(f"failed to save JSON {filepath}: {e}")
        return False


def safe_json_load(filepath, default: Any = None) -> Any:
    """Load JSON, returning `default` on any failure."""
    try:
        with open(filepath, "r") as f:
            return json.load(f)
    except Exception:  # noqa: BLE001
        return default
