"""Family-D checkpoints for the port.

The port's state dict IS the reference's: `CausalAnomalyDetector`'s module
names give the keys of ``best_improved_model.pth``.  This module

- loads the three ``.pth`` formats the reference writes;
- keeps training checkpoints (`CheckpointManager`, the torch-native
  counterpart of `cvad_tpu/runtime/checkpoint.py:26-110`);
- converts between the port's state dict and `cvad_tpu`'s flax parameters,
  and from optax's Adam state to the port's (`from_jax_opt_state`), numpy in
  and out, for the parity tests.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from cvad_tpu_torch.utils.json_utils import safe_json_load, safe_json_save

Step = Union[int, str]


class CheckpointManager:
    """One directory per ``step_%08d``, plus ``best`` and ``mid``, each
    holding ``model.pth`` and, when given, ``history.json``.

    ``model.pth`` is ``{"model_state_dict": ..., "optimizer": ...,
    "step": ...}``: `load_torch_state_dict` (and so ``cli serve``) reads its
    weights directly.  Every save is written whole into a sibling
    ``_tmp.<name>`` directory first and then swapped in with two renames, so
    a crash mid-save leaves the previous checkpoint of that name (or, between
    the renames, its ``_old.<name>`` copy and the epoch checkpoints) intact.
    The step directories beyond the newest `max_to_keep` are removed.
    Saves are synchronous.
    """

    FILE = "model.pth"

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _step_dir(self, step: Step) -> Path:
        return self.directory / (step if isinstance(step, str)
                                 else f"step_{step:08d}")

    def path(self, step: Step) -> Path:
        """The ``model.pth`` of a checkpoint."""
        return self._step_dir(step) / self.FILE

    def save(self, step: Step, state: Any,
             history: Optional[Mapping] = None) -> Path:
        """Save `state` (a `TrainState`, or its ``state_dict()``)."""
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        path = self._step_dir(step)
        # "_tmp."/"_old." prefixes: a suffix would match the step_* glob
        tmp = path.with_name("_tmp." + path.name)
        old = path.with_name("_old." + path.name)
        for p in (tmp, old):
            if p.exists():
                shutil.rmtree(p)
        tmp.mkdir()
        torch.save(payload, tmp / self.FILE)
        if history is not None:
            safe_json_save(dict(history), tmp / "history.json",
                           verbose=False)
        if path.exists():
            path.rename(old)
        tmp.rename(path)
        shutil.rmtree(old, ignore_errors=True)
        self._gc()
        return path

    def restore(self, step: Step) -> dict:
        """The saved ``state_dict`` (tensors on the CPU)."""
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore_history(self, step: Step) -> Optional[dict]:
        return safe_json_load(self._step_dir(step) / "history.json")

    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*"))
        return steps[-1] if steps else None

    def remove(self, step: Step) -> None:
        """Delete a checkpoint (e.g. the rolling 'mid' snapshot once its
        run completed)."""
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _gc(self) -> None:
        steps = sorted(self.directory.glob("step_*"))
        for p in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(p, ignore_errors=True)

# state-dict key prefix -> (flax module path, kind); own copy of
# cvad_tpu/runtime/checkpoint.py::_FAMILY_D_MAP
FAMILY_D_KEYS = {
    "feature_extractor.conv3d_1": ("feature_extractor/conv3d_1/conv", "conv3d"),
    "feature_extractor.conv3d_2": ("feature_extractor/conv3d_2/conv", "conv3d"),
    "feature_extractor.conv3d_3": ("feature_extractor/conv3d_3/conv", "conv3d"),
    "feature_extractor.fc": ("feature_extractor/fc", "dense"),
    "causal_discovery.causal_net.0": ("causal_discovery/net_0", "dense"),
    "causal_discovery.causal_net.2": ("causal_discovery/net_2", "dense"),
    "graph_encoder.0": ("graph_encoder_0", "dense"),
    "graph_encoder.3": ("graph_encoder_3", "dense"),
    "anomaly_predictor.0": ("anomaly_predictor_0", "dense"),
    "anomaly_predictor.2": ("anomaly_predictor_2", "dense"),
}
# flax kernel axes -> torch weight axes
_TO_TORCH = {"conv3d": (4, 3, 0, 1, 2),   # (kT,kH,kW,I,O) -> (O,I,kT,kH,kW)
             "dense": (1, 0)}             # (I,O) -> (O,I)
_TO_FLAX = {"conv3d": (2, 3, 4, 1, 0), "dense": (1, 0)}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth`` in any of the reference's three formats: a raw state
    dict, ``{'model_state_dict': ...}`` or ``{'state_dict': ...}``.  Only
    tensors and plain containers are unpickled (``weights_only=True``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict"):
            if key in obj:
                obj = obj[key]
                break
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def from_jax_family_d(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`cvad_tpu` family-D variables ``{'params': ...}`` (numpy or array
    leaves) -> the port's state dict."""
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    for prefix, (flax_path, kind) in FAMILY_D_KEYS.items():
        node = params
        for part in flax_path.split("/"):
            node = node[part]
        k = np.transpose(np.asarray(node["kernel"]), _TO_TORCH[kind])
        out[f"{prefix}.weight"] = torch.from_numpy(
            np.array(k, np.float32, order="C"))
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.array(node["bias"], np.float32))
    return out


def to_jax_family_d(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> `cvad_tpu` family-D variables with numpy
    leaves (inverse of `from_jax_family_d`)."""
    params: Dict[str, Any] = {}
    for prefix, (flax_path, kind) in FAMILY_D_KEYS.items():
        node = params
        for part in flax_path.split("/"):
            node = node.setdefault(part, {})
        w = state[f"{prefix}.weight"].detach().cpu().numpy()
        node["kernel"] = np.ascontiguousarray(np.transpose(w, _TO_FLAX[kind]))
        node["bias"] = state[f"{prefix}.bias"].detach().cpu().numpy().copy()
    return {"params": params}


def _find(node: Any, pred) -> Any:
    """First node of an optax state tree (tuples and NamedTuples) for which
    `pred` holds, depth first."""
    if pred(node):
        return node
    if isinstance(node, tuple):
        for child in node:
            found = _find(child, pred)
            if found is not None:
                return found
    return None


def from_jax_opt_state(opt_state: Any, model: torch.nn.Module):
    """`cvad_tpu`'s optax state (``build_optimizer``'s: a clip, then
    ``inject_hyperparams`` around adam or adamw; numpy leaves) -> the
    port's `OptState` over `model`'s flat parameter vector: both Adam
    moments, Adam's count and the injected learning rate."""
    from cvad_tpu_torch.train.optim import OptState, flatten

    inject = _find(opt_state, lambda s: "learning_rate" in (
        getattr(s, "hyperparams", None) or {}))
    adam = _find(inject.inner_state,
                 lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
    moments = []
    for tree in (adam.mu, adam.nu):
        by_key = from_jax_family_d({"params": tree})
        moments.append(flatten(by_key[name]
                               for name, _ in model.named_parameters()))
    dev = next(model.parameters()).device
    return OptState(
        mu=moments[0], nu=moments[1],
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
        lr=torch.tensor(float(np.asarray(inject.hyperparams["learning_rate"])),
                        dtype=torch.float32)).to(dev)
