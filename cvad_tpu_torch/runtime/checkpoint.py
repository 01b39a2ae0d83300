"""Checkpoints of families D, B, C, A and E for the port.

The port's state dicts ARE the reference's: `CausalAnomalyDetector`'s module
names give the keys of ``best_improved_model.pth``,
`MemoryVideoAutoEncoder`'s those of the reference ``VideoAutoEncoder``
(plus ``memory_fill``, which `cvad_tpu`'s importer ignores),
`Simple3DCNNDetector`'s those of ``SimpleVideoAnomalyDetector`` and
`CausalPipelineDetector`'s those of the reference
``CausalAnomalyDetector`` of ``causal_anomaly_detection.py`` (or, in the
anchor variant, of ``video_anomaly_detection.py``) and `BBoxVizDetector`'s
those of ``avenue_training_script_bbox.py``'s.  This module

- loads the three ``.pth`` formats the reference writes;
- keeps training checkpoints (`CheckpointManager`, the torch-native
  counterpart of `cvad_tpu/runtime/checkpoint.py:26-110`);
- converts between the port's state dicts and `cvad_tpu`'s flax variables
  (family B's memory bank and the BatchNorm statistics included), and from
  optax's Adam state to the port's (`from_jax_opt_state`), numpy in and
  out, for the parity tests.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

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


def _bn_from(out: Dict, prefix: str, params: Mapping, stats: Optional[Mapping],
             path: str) -> None:
    node = _node(params, path)
    out[f"{prefix}.weight"] = _t(node["scale"])
    out[f"{prefix}.bias"] = _t(node["bias"])
    if stats is not None:
        st = _node(stats, path)
        out[f"{prefix}.running_mean"] = _t(st["mean"])
        out[f"{prefix}.running_var"] = _t(st["var"])
        out[f"{prefix}.num_batches_tracked"] = torch.zeros((),
                                                           dtype=torch.long)


def _bn_to(state: Mapping, prefix: str, params: Dict, stats: Dict,
           path: str) -> None:
    def a(k):
        return state[f"{prefix}.{k}"].detach().cpu().numpy()

    _put(params, path, {"scale": a("weight"), "bias": a("bias")})
    _put(stats, path, {"mean": a("running_mean"), "var": a("running_var")})


def _dense_from(node: Mapping, rows: Optional[np.ndarray] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A flax Dense (in, out) -> a Linear's (out, in) weight and bias; with
    `rows`, the kernel's input rows are taken in that order first."""
    k = np.asarray(node["kernel"])
    if rows is not None:
        k = k[rows]
    return _t(k.T), _t(node["bias"])


def _dense_to(state: Mapping, prefix: str,
              rows: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    k = state[f"{prefix}.weight"].detach().cpu().numpy().T
    if rows is not None:
        k = k[rows]
    return {"kernel": np.ascontiguousarray(k),
            "bias": state[f"{prefix}.bias"].detach().cpu().numpy()}


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
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = _dense_from(
            _node(params, path))
    stats = variables.get("batch_stats")
    for prefix, path in FAMILY_B_BNS.items():
        _bn_from(out, prefix, params, stats, path)
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
        _put(params, path, _dense_to(state, prefix))
    for prefix, path in FAMILY_B_BNS.items():
        _bn_to(state, prefix, params, stats, path)
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


# family C: state-dict index -> flax name, own copy of the maps of
# cvad_tpu/runtime/checkpoint.py::import_torch_family_c (:275-294)
FAMILY_C_BLOCKS = ((0, 1), (4, 5), (8, 9))  # features.(conv, BatchNorm)
FAMILY_C_DENSES = ((1, "cls_1"), (4, "cls_4"), (6, "cls_6"))


def from_jax_family_c(variables: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """`cvad_tpu` family-C variables ``{'params', 'batch_stats'}`` (numpy
    or array leaves) -> the port's state dict.  Without ``batch_stats``
    (an Adam moment tree), only the parameters are filled."""
    params, stats = variables["params"], variables.get("batch_stats")
    out: Dict[str, torch.Tensor] = {}
    for i, (conv, bn) in enumerate(FAMILY_C_BLOCKS):
        node = params[f"conv_{i}"]["conv"]
        out[f"features.{conv}.weight"] = _t(np.transpose(
            np.asarray(node["kernel"]), _TO_TORCH["conv3d"]))
        out[f"features.{conv}.bias"] = _t(node["bias"])
        _bn_from(out, f"features.{bn}", params, stats, f"bn_{i}")
    for idx, name in FAMILY_C_DENSES:
        out[f"classifier.{idx}.weight"], out[f"classifier.{idx}.bias"] = \
            _dense_from(params[name])
    return out


def to_jax_family_c(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's family-C state dict -> `cvad_tpu` variables
    ``{'params', 'batch_stats'}`` with numpy leaves (inverse of
    `from_jax_family_c`)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i, (conv, bn) in enumerate(FAMILY_C_BLOCKS):
        w = state[f"features.{conv}.weight"].detach().cpu().numpy()
        params[f"conv_{i}"] = {"conv": {
            "kernel": np.ascontiguousarray(np.transpose(w, _TO_FLAX["conv3d"])),
            "bias": state[f"features.{conv}.bias"].detach().cpu().numpy()}}
        _bn_to(state, f"features.{bn}", params, stats, f"bn_{i}")
    for idx, name in FAMILY_C_DENSES:
        params[name] = _dense_to(state, f"classifier.{idx}")
    return {"params": params, "batch_stats": stats}


# family E: state-dict prefix -> (flax module path, kind); own copy of
# cvad_tpu/runtime/checkpoint.py::_FAMILY_E_MAP (:448-455).  Both sides
# flatten the features channel major, so the dense weights carry as they are.
FAMILY_E_KEYS = {
    "encoder.0": ("enc_conv0/conv", "conv3d"),
    "encoder.3": ("enc_conv3/conv", "conv3d"),
    "causal_net.0": ("causal_0", "dense"),
    "causal_net.2": ("causal_2", "dense"),
    "classifier.0": ("cls_0", "dense"),
    "classifier.3": ("cls_3", "dense"),
}


def from_jax_family_e(variables: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """`cvad_tpu` family-E variables ``{'params': ...}`` (numpy or array
    leaves) -> the port's state dict (the mirror of `cvad_tpu`'s
    ``export_family_e_torch_state``, :482-497)."""
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    for prefix, (flax_path, kind) in FAMILY_E_KEYS.items():
        node = _node(params, flax_path)
        out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(node["kernel"]),
                                                  _TO_TORCH[kind]))
        out[f"{prefix}.bias"] = _t(node["bias"])
    return out


def to_jax_family_e(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's family-E state dict -> `cvad_tpu` variables
    ``{'params': ...}`` with numpy leaves (inverse of `from_jax_family_e`,
    the mirror of ``import_torch_family_e``, :458-479)."""
    params: Dict[str, Any] = {}
    for prefix, (flax_path, kind) in FAMILY_E_KEYS.items():
        w = state[f"{prefix}.weight"].detach().cpu().numpy()
        _put(params, flax_path, {
            "kernel": np.ascontiguousarray(np.transpose(w, _TO_FLAX[kind])),
            "bias": state[f"{prefix}.bias"].detach().cpu().numpy().copy()})
    return {"params": params}


def family_a_feature_permutation(pool_hw=(4, 6), channels: int = 256
                                 ) -> np.ndarray:
    """`cvad_tpu`'s row permutation (checkpoint.py:297-307): row r of its
    (h, w, c)-flattened backbone features is row ``perm[r]`` of the
    channel-major flatten (c * H * W + h * W + w) that the reference and
    the port use."""
    ph, pw = pool_hw
    h, w, c = np.meshgrid(np.arange(ph), np.arange(pw), np.arange(channels),
                          indexing="ij")
    return (c * (ph * pw) + h * pw + w).reshape(-1)


def _family_a_layout(cfg) -> Dict[str, Any]:
    """The index maps of `cvad_tpu`'s ``import_torch_family_a``
    (checkpoint.py:310-441) for `cfg` (a `FamilyAConfig`): state-dict
    prefix -> flax path of every Dense, and which of them read the
    backbone features."""
    denses = {}
    if cfg.anchor_variant:
        for head in ("bbox_head", "conf_head"):
            denses[f"detector.{head}"] = f"detector/{head}"
    else:
        for i, idx in enumerate((0, 3, 6, 8)):
            denses[f"detector.detector_net.{idx}"] = \
                f"detector/detector_net/dense_{i}"
        denses["detector.detector_net.10"] = "detector/detector_out"
    for i in (0, 2, 4):
        denses[f"tracker.reid_net.{i}"] = f"tracker/reid_{i}"
    denses["traj_encoder.encoder"] = "traj_encoder/encoder"
    for i in (0, 2):
        denses[f"causal_extractor.encoder.{i}"] = f"causal_extractor/enc_{i}"
    for head in ("mu_head", "logvar_head"):
        denses[f"causal_extractor.{head}"] = f"causal_extractor/{head}"
    denses["structure_learner.node_encoder"] = \
        "structure_learner/node_encoder"
    for i in (0, 2):
        denses[f"structure_learner.edge_predictor.{i}"] = \
            f"structure_learner/edge_{i}"
    for i in (0, 2, 4):
        denses[f"dynamics_predictor.dynamics_net.{i}"] = \
            f"dynamics_predictor/dyn_{i}"
    heads = ((("score_net", (0, 2, 4)),) if cfg.anchor_variant else
             (("causal_scorer", (0, 3, 5)), ("motion_scorer", (0, 2, 4)),
              ("temporal_scorer", (0, 2, 4))))
    for head, idxs in heads:
        for i, idx in enumerate(idxs):
            denses[f"anomaly_scorer.{head}.{idx}"] = \
                f"anomaly_scorer/{head}/dense_{i}"
    if cfg.direct_variant:
        for i, idx in enumerate((0, 3, 6, 8, 10)):
            denses[f"direct_classifier.{idx}"] = \
                f"direct_classifier/dense_{i}"
    reads_features = {"detector.bbox_head", "detector.conf_head",
                      "detector.detector_net.0", "direct_classifier.0"}
    convs = {"backbone.conv1": "backbone/conv1"}
    bns = {"backbone.bn1": "backbone/bn1"}
    for n in range(1, 5):
        convs[f"backbone.layer{n}.0"] = f"backbone/layer{n}_conv0"
        convs[f"backbone.layer{n}.3"] = f"backbone/layer{n}_conv1"
        bns[f"backbone.layer{n}.1"] = f"backbone/layer{n}_bn0"
        bns[f"backbone.layer{n}.4"] = f"backbone/layer{n}_bn1"
    perm = family_a_feature_permutation(tuple(cfg.backbone_pool),
                                        cfg.backbone_channels[-1])
    return {"denses": denses, "reads_features": reads_features,
            "convs": convs, "bns": bns, "perm": perm}


_GRU = "traj_encoder.gru"
_GRU_GATES = ("r", "z", "n")  # row blocks of torch's fused (3H, .) weights


def from_jax_family_a(variables: Mapping[str, Any], cfg
                      ) -> Dict[str, torch.Tensor]:
    """`cvad_tpu` family-A variables ``{'params', 'batch_stats'}`` for the
    `FamilyAConfig` `cfg` -> the port's state dict.

    Conv kernels (kH, kW, I, O) become (O, I, kH, kW); the GRU's per-gate
    denses the fused (3H, .) weights in gate order r, z, n, flax's input
    biases ``bias_ih_l0`` and its ``hn`` bias the n third of
    ``bias_hh_l0`` (r and z thirds zero); the Denses that read the
    backbone features take their rows back to the channel-major order
    (the inverse of `family_a_feature_permutation` for the config's pool
    and last width).  Without ``batch_stats`` only the parameters are
    filled."""
    params, stats = variables["params"], variables.get("batch_stats")
    lay = _family_a_layout(cfg)
    inverse = np.argsort(lay["perm"])
    out: Dict[str, torch.Tensor] = {}
    for prefix, path in lay["convs"].items():
        node = _node(params, path)
        out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(node["kernel"]),
                                                  (3, 2, 0, 1)))
        out[f"{prefix}.bias"] = _t(node["bias"])
    for prefix, path in lay["bns"].items():
        _bn_from(out, prefix, params, stats, path)
    for prefix, path in lay["denses"].items():
        rows = inverse if prefix in lay["reads_features"] else None
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = _dense_from(
            _node(params, path), rows)
    cell = params["traj_encoder"]["GRUCell_0"]
    out[f"{_GRU}.weight_ih_l0"] = _t(np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GRU_GATES]))
    out[f"{_GRU}.weight_hh_l0"] = _t(np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GRU_GATES]))
    out[f"{_GRU}.bias_ih_l0"] = _t(np.concatenate(
        [np.asarray(cell[f"i{g}"]["bias"]) for g in _GRU_GATES]))
    b_hn = np.asarray(cell["hn"]["bias"])
    out[f"{_GRU}.bias_hh_l0"] = _t(np.concatenate(
        [np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn]))
    out["structure_learner.structure_params"] = _t(
        params["structure_learner"]["structure_params"])
    return out


def to_jax_family_a(state: Mapping[str, torch.Tensor], cfg
                    ) -> Dict[str, Any]:
    """The port's family-A state dict -> `cvad_tpu` variables
    ``{'params', 'batch_stats'}`` with numpy leaves for `cfg` (inverse of
    `from_jax_family_a`; a reference state dict's r and z hidden biases
    join flax's input biases, as `import_torch_family_a` adds them)."""
    lay = _family_a_layout(cfg)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def a(key: str) -> np.ndarray:
        return state[key].detach().cpu().numpy()

    for prefix, path in lay["convs"].items():
        _put(params, path, {"kernel": np.ascontiguousarray(
            np.transpose(a(f"{prefix}.weight"), (2, 3, 1, 0))),
            "bias": a(f"{prefix}.bias")})
    for prefix, path in lay["bns"].items():
        _bn_to(state, prefix, params, stats, path)
    for prefix, path in lay["denses"].items():
        rows = lay["perm"] if prefix in lay["reads_features"] else None
        _put(params, path, _dense_to(state, prefix, rows))
    w_ih, w_hh = a(f"{_GRU}.weight_ih_l0"), a(f"{_GRU}.weight_hh_l0")
    b_ih, b_hh = a(f"{_GRU}.bias_ih_l0"), a(f"{_GRU}.bias_hh_l0")
    h = w_hh.shape[1]
    cell: Dict[str, Any] = {}
    for gi, g in enumerate(_GRU_GATES):
        rows = slice(gi * h, (gi + 1) * h)
        bias = b_ih[rows] if g == "n" else b_ih[rows] + b_hh[rows]
        cell[f"i{g}"] = {"kernel": np.ascontiguousarray(w_ih[rows].T),
                         "bias": bias}
        cell[f"h{g}"] = {"kernel": np.ascontiguousarray(w_hh[rows].T)}
    cell["hn"]["bias"] = b_hh[2 * h:]
    params.setdefault("traj_encoder", {})["GRUCell_0"] = cell
    _put(params, "structure_learner/structure_params",
         a("structure_learner.structure_params"))
    return {"params": params, "batch_stats": stats}


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
        moments.append(flatten(by_key[name] for name, p in
                               model.named_parameters() if p.requires_grad))
    dev = next(model.parameters()).device
    return OptState(
        mu=moments[0], nu=moments[1],
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
        lr=torch.tensor(float(np.asarray(inject.hyperparams["learning_rate"])),
                        dtype=torch.float32)).to(dev)
