"""Checkpoints of families D and B for the port.

The port's state dicts ARE the reference's: `CausalAnomalyDetector`'s module
names give the keys of ``best_improved_model.pth``, and
`MemoryVideoAutoEncoder`'s those of the reference ``VideoAutoEncoder``
(plus ``memory_fill``, which `cvad_tpu`'s importer ignores).  This module

- loads the three ``.pth`` formats the reference writes;
- keeps training checkpoints (`CheckpointManager`, the torch-native
  counterpart of `cvad_tpu/runtime/checkpoint.py:26-110`);
- converts between the port's state dicts and `cvad_tpu`'s flax variables
  (family B's memory bank included), and from optax's Adam state to the
  port's (`from_jax_opt_state`), numpy in and out, for the parity tests.
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


# family B: state-dict prefix -> flax path; own copy of the index maps of
# cvad_tpu/runtime/checkpoint.py::import_torch_family_b (:224-250)
FAMILY_B_CONVS = {"encoder.0": "encoder/conv_0", "encoder.3": "encoder/conv_1",
                  "encoder.6": "encoder/conv_2", "encoder.9": "encoder/conv_3",
                  "decoder.3": "decoder/deconv_0",
                  "decoder.6": "decoder/deconv_1",
                  "decoder.9": "decoder/deconv_2",
                  "decoder.12": "decoder/deconv_out"}
FAMILY_B_DENSES = {"encoder.13": "encoder/fc", "decoder.0": "decoder/fc"}
FAMILY_B_BNS = {"encoder.1": "encoder/bn_0", "encoder.4": "encoder/bn_1",
                "encoder.7": "encoder/bn_2", "encoder.10": "encoder/bn_3",
                "decoder.4": "decoder/bn_0", "decoder.7": "decoder/bn_1",
                "decoder.10": "decoder/bn_2"}
_LSTM = "temporal_encoder"
_GATES = ("i", "f", "g", "o")  # row blocks of torch's fused (4H, .) weights
_ATTN = "temporal."  # the attention encoder's state-dict prefix


def _node(tree: Mapping, path: str) -> Any:
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _put(tree: Dict, path: str, value: Any) -> None:
    *parents, leaf = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def from_jax_temporal(tree: Mapping[str, Any], prefix: str = ""
                      ) -> Dict[str, torch.Tensor]:
    """`cvad_tpu`'s attention-encoder parameters (the ``temporal`` tree, or
    one block's) -> state-dict entries under `prefix`: a Dense's (in, out)
    kernel becomes the Linear's (out, in) weight, a LayerNorm's scale and
    bias its weight and bias, and ``pos_embed`` is copied as it is."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        key = prefix + name
        if not isinstance(node, Mapping):
            out[key] = _t(node)
        elif "kernel" in node:
            out[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
            out[f"{key}.bias"] = _t(node["bias"])
        elif "scale" in node:
            out[f"{key}.weight"] = _t(node["scale"])
            out[f"{key}.bias"] = _t(node["bias"])
        else:
            out.update(from_jax_temporal(node, key + "."))
    return out


def to_jax_temporal(state: Mapping[str, torch.Tensor], prefix: str = ""
                    ) -> Dict[str, Any]:
    """The inverse of `from_jax_temporal` over the entries of `state` under
    `prefix`, numpy leaves: a 2-D ``weight`` is a Dense kernel, a 1-D one a
    LayerNorm scale."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        a = value.detach().cpu().numpy()
        if leaf == "weight":
            leaf, a = ("kernel", np.ascontiguousarray(a.T)) if a.ndim == 2 \
                else ("scale", a)
        _put(tree, "/".join([*path, leaf]), a)
    return tree


def from_jax_family_b(variables: Mapping[str, Any], memory: Any = None
                      ) -> Dict[str, torch.Tensor]:
    """`cvad_tpu` family-B variables ``{'params', 'batch_stats'}`` and its
    `MemoryBankState` (numpy or array leaves) -> the port's state dict.

    Conv and deconv kernels (kH, kW, I, O) / (kH, kW, O, I) become torch's
    (O, I, kH, kW) / (I, O, kH, kW); the LSTM's per-gate denses become the
    fused (4H, .) weights in gate order i, f, g, o, with flax's one bias as
    ``bias_ih_l0`` and ``bias_hh_l0`` zero; the attention encoder's
    ``temporal`` tree maps by `from_jax_temporal`.  Without ``batch_stats``
    (e.g. an Adam moment tree) or `memory`, only the parameters are
    filled."""
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    for prefix, path in FAMILY_B_CONVS.items():
        node = _node(params, path)
        out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(node["kernel"]),
                                                  (3, 2, 0, 1)))
        out[f"{prefix}.bias"] = _t(node["bias"])
    for prefix, path in FAMILY_B_DENSES.items():
        node = _node(params, path)
        out[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
        out[f"{prefix}.bias"] = _t(node["bias"])
    stats = variables.get("batch_stats")
    for prefix, path in FAMILY_B_BNS.items():
        node = _node(params, path)
        out[f"{prefix}.weight"] = _t(node["scale"])
        out[f"{prefix}.bias"] = _t(node["bias"])
        if stats is not None:
            st = _node(stats, path)
            out[f"{prefix}.running_mean"] = _t(st["mean"])
            out[f"{prefix}.running_var"] = _t(st["var"])
            out[f"{prefix}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    if "temporal" in params:
        out.update(from_jax_temporal(params["temporal"], _ATTN))
    else:
        lstm = params["lstm"]
        out[f"{_LSTM}.weight_ih_l0"] = _t(np.concatenate(
            [np.asarray(lstm[f"i{g}"]["kernel"]).T for g in _GATES]))
        out[f"{_LSTM}.weight_hh_l0"] = _t(np.concatenate(
            [np.asarray(lstm[f"h{g}"]["kernel"]).T for g in _GATES]))
        out[f"{_LSTM}.bias_ih_l0"] = _t(np.concatenate(
            [np.asarray(lstm[f"h{g}"]["bias"]) for g in _GATES]))
        out[f"{_LSTM}.bias_hh_l0"] = torch.zeros_like(
            out[f"{_LSTM}.bias_ih_l0"])
    if memory is not None:
        mem, ptr, fill = (np.asarray(v) for v in memory)
        out["normal_memory"] = _t(mem)
        out["memory_ptr"] = torch.tensor([int(ptr)], dtype=torch.long)
        out["memory_fill"] = torch.tensor([int(fill)], dtype=torch.long)
    return out


def to_jax_family_b(state: Mapping[str, torch.Tensor]):
    """The port's state dict -> (`cvad_tpu` family-B variables with numpy
    leaves, (memory, ptr, fill) as numpy): the inverse of
    `from_jax_family_b`.  ``bias_ih_l0 + bias_hh_l0`` becomes flax's one
    bias, the attention encoder's entries its ``temporal`` tree, and a state
    dict without ``memory_fill`` gives fill = ptr."""
    def a(key: str) -> np.ndarray:
        return state[key].detach().cpu().numpy()

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for prefix, path in FAMILY_B_CONVS.items():
        kernel = np.transpose(a(f"{prefix}.weight"), (2, 3, 1, 0))
        _put(params, path, {"kernel": np.ascontiguousarray(kernel),
                            "bias": a(f"{prefix}.bias")})
    for prefix, path in FAMILY_B_DENSES.items():
        _put(params, path, {"kernel": np.ascontiguousarray(
            a(f"{prefix}.weight").T), "bias": a(f"{prefix}.bias")})
    for prefix, path in FAMILY_B_BNS.items():
        _put(params, path, {"scale": a(f"{prefix}.weight"),
                            "bias": a(f"{prefix}.bias")})
        _put(stats, path, {"mean": a(f"{prefix}.running_mean"),
                           "var": a(f"{prefix}.running_var")})
    if any(k.startswith(_ATTN) for k in state):
        params["temporal"] = to_jax_temporal(state, _ATTN)
    else:
        w_ih, w_hh = a(f"{_LSTM}.weight_ih_l0"), a(f"{_LSTM}.weight_hh_l0")
        bias = a(f"{_LSTM}.bias_ih_l0") + a(f"{_LSTM}.bias_hh_l0")
        h = w_hh.shape[1]
        lstm = params.setdefault("lstm", {})
        for gi, g in enumerate(_GATES):
            rows = slice(gi * h, (gi + 1) * h)
            lstm[f"i{g}"] = {"kernel": np.ascontiguousarray(w_ih[rows].T)}
            lstm[f"h{g}"] = {"kernel": np.ascontiguousarray(w_hh[rows].T),
                             "bias": bias[rows]}
    ptr = int(a("memory_ptr").reshape(-1)[0])
    fill = (int(a("memory_fill").reshape(-1)[0]) if "memory_fill" in state
            else ptr)
    memory = (a("normal_memory"), np.asarray(ptr, np.int32),
              np.asarray(fill, np.int32))
    return {"params": params, "batch_stats": stats}, memory


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


def from_jax_opt_state(opt_state: Any, model: torch.nn.Module,
                       convert=from_jax_family_d):
    """`cvad_tpu`'s optax state (``build_optimizer``'s: a clip, then
    ``inject_hyperparams`` around adam or adamw; numpy leaves) -> the
    port's `OptState` over `model`'s flat parameter vector: both Adam
    moments, Adam's count and the injected learning rate.  `convert` maps
    a parameter tree to state-dict keys (`from_jax_family_b` for family
    B)."""
    from cvad_tpu_torch.train.optim import OptState, flatten

    inject = _find(opt_state, lambda s: "learning_rate" in (
        getattr(s, "hyperparams", None) or {}))
    adam = _find(inject.inner_state,
                 lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
    moments = []
    for tree in (adam.mu, adam.nu):
        by_key = convert({"params": tree})
        moments.append(flatten(by_key[name]
                               for name, _ in model.named_parameters()))
    dev = next(model.parameters()).device
    return OptState(
        mu=moments[0], nu=moments[1],
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
        lr=torch.tensor(float(np.asarray(inject.hyperparams["learning_rate"])),
                        dtype=torch.float32)).to(dev)
