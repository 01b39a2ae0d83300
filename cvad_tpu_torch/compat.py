"""Reference-API compatibility layer of the port.

Port of `cvad_tpu/compat.py`: drop-in equivalents of the reference's
trainer classes and drivers, so that code written against the reference
runs on the port's family-D task (`train/tasks.py`) on the card:

- `MiniCausalVAD`: the reference's missing module ``minicausal_vad`` as
  its call sites use it (``avenue_training_script1.py:20,101,105,141,161,
  199``): ``MiniCausalVAD(device=)``, ``.model`` (the family-D
  ``nn.Module`` itself: ``.parameters()``, ``.state_dict()``, ``.eval()``,
  called on (B, C, T, H, W) clips), ``.optimizer.param_groups`` (writing
  ``'lr'`` sets the optimizer's learning rate), ``.device``,
  ``train_epoch(loader) -> (loss, components)``, ``evaluate(loader) ->
  (predictions, None, causal_graphs)``, ``save_model`` / ``load_model``
  (the reference's ``.pth``: ``{"model_state_dict": ...}``, loaded with
  ``strict=True``);
- `ImprovedMiniCausalVAD` (``avenue_training_script2.py:107-297``):
  ``train_epoch_improved`` steps the plateau scheduler once an epoch on
  the average loss, ``evaluate_improved -> (predictions, causal_graphs,
  metrics)`` with the 8 metrics of `family_d_eval_metrics`,
  ``compute_improved_loss``;
- `create_unsupervised_labels` (``avenue_training_script1.py:36-67``):
  pseudo-labels above the scores' 95th percentile;
- `train_minicausal_vad_on_avenue` / `train_improved_minicausal_vad`: the
  two Avenue driver loops (v1 history with evaluation_scores,
  causal_sparsity and timestamps, best by mean score; v2 best by
  score_range);
- `setup_training_environment` and `test_trained_model`: the drivers'
  device probe and the evaluation of a saved model.

Device: CUDA by default (`runtime/device.py::resolve_device`, which raises
without a card); ``device="cpu"`` runs the kernels' plain versions.  On
the card the train step runs K1 forward and K2 forward and backward, and
`evaluate` runs K1.  Loaders may yield the framework's dict batches or the
reference's ``(videos, labels)`` tuples, in either layout, numpy or
tensors: (B, C, T, H, W) clips are transposed to channels-last, and an
injected ``pseudo_targets`` entry of a dict batch reaches the step in
place of its own draw.  Metrics accumulate on the device, with one host
fetch an epoch.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from cvad_tpu_torch.config import ExperimentConfig, preset
from cvad_tpu_torch.evaluation.metrics import family_d_eval_metrics
from cvad_tpu_torch.runtime.device import resolve_device
from cvad_tpu_torch.train.optim import HostScheduler, get_lr, set_lr
from cvad_tpu_torch.train.tasks import build_task
from cvad_tpu_torch.utils.json_utils import safe_json_save


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_framework_batch(item) -> Dict[str, np.ndarray]:
    """A loader's item as the framework's batch: float32 channels-last
    clips (B, T, H, W, C), float32 labels, and an injected
    ``pseudo_targets`` passed through."""
    if isinstance(item, dict):
        clips, labels = item["clips"], item["labels"]
    else:
        clips, labels = item
    clips = _host(clips).astype(np.float32)
    if (clips.ndim == 5 and clips.shape[1] in (1, 3)
            and clips.shape[-1] not in (1, 3)):
        clips = np.transpose(clips, (0, 2, 3, 4, 1))  # torch -> channels-last
    out = {"clips": np.ascontiguousarray(clips),
           "labels": _host(labels).astype(np.float32).reshape(-1)}
    if isinstance(item, dict) and "pseudo_targets" in item:
        out["pseudo_targets"] = _host(item["pseudo_targets"]).astype(
            np.float32).reshape(-1)
    return out


class _ParamGroup(dict):
    """A torch-style param group: writing ``'lr'`` sets the optimizer's
    learning rate (and the scheduler's)."""

    def __init__(self, owner: "MiniCausalVAD"):
        super().__init__(lr=owner._lr())
        self._owner = owner

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if key == "lr":
            self._owner._set_lr(float(value))

    def __getitem__(self, key):
        if key == "lr":
            return self._owner._lr()
        return super().__getitem__(key)


class _OptimizerHandle:
    def __init__(self, owner: "MiniCausalVAD"):
        self._owner = owner

    @property
    def param_groups(self) -> List[_ParamGroup]:
        return [_ParamGroup(self._owner)]


class MiniCausalVAD:
    """The reference's trainer interface over the port's family-D task."""

    def __init__(self, device=None, cfg: Optional[ExperimentConfig] = None):
        self.cfg = cfg or preset("family_d")
        self.device = resolve_device(device)
        self.task = build_task(self.cfg)
        self.state = self.task.init_state(self.cfg.train.seed, self.device)
        self.scheduler = HostScheduler(self.cfg.optim)
        self.optimizer = _OptimizerHandle(self)

    @property
    def model(self) -> torch.nn.Module:
        """The family-D module the steps train in place."""
        return self.state.model

    # -- internals -----------------------------------------------------------

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _eval_outputs(self, item) -> Dict[str, torch.Tensor]:
        """The eval step's outputs of one loader item, on the device."""
        return self.task.eval_step(self.state,
                                   self._put(_to_framework_batch(item)))

    def _lr(self) -> float:
        return get_lr(self.state.opt_state)

    def _set_lr(self, lr: float) -> None:
        self.scheduler.lr = lr
        self.scheduler.base_lr = lr
        set_lr(self.state.opt_state, lr)

    # -- reference API -------------------------------------------------------

    def train_epoch(self, dataloader: Iterable
                    ) -> Tuple[float, Dict[str, float]]:
        """One pass over `dataloader`: (mean loss, mean of each loss
        component), summed on the device and fetched once."""
        keys: Optional[List[str]] = None
        acc: Optional[torch.Tensor] = None
        count = 0
        for item in dataloader:
            batch = self._put(_to_framework_batch(item))
            self.state, metrics = self.task.train_step(
                self.state, batch, self.cfg.train.seed)
            keys = keys or list(metrics)
            vec = torch.stack([metrics[k].float() for k in keys])
            acc = vec if acc is None else acc + vec
            count += 1
        if acc is None:
            return 0.0, {}
        host = dict(zip(keys, acc.cpu().numpy().tolist()))
        loss_sum = host.pop("loss", 0.0)
        return loss_sum / count, {k: v / count for k, v in host.items()}

    @torch.no_grad()
    def evaluate(self, dataloader: Iterable):
        """(predictions (N,), None, causal graphs (N, 16, 16)) of every
        clip of `dataloader`, numpy, fetched once."""
        preds: List[torch.Tensor] = []
        graphs: List[torch.Tensor] = []
        for item in dataloader:
            out = self._eval_outputs(item)
            preds.append(out["predictions"].reshape(-1))
            graphs.append(out["causal_graphs"])
        if not preds:
            return np.zeros(0), None, np.zeros((0, 16, 16))
        return (torch.cat(preds).cpu().numpy(), None,
                torch.cat(graphs).cpu().numpy())

    def save_model(self, path: str) -> None:
        """The reference's ``.pth``: ``{"model_state_dict": ...}``."""
        torch.save({"model_state_dict": {
            k: v.detach().cpu().clone()
            for k, v in self.model.state_dict().items()}}, path)

    def load_model(self, path: str) -> None:
        """Weights from a ``.pth`` in any of the reference's formats,
        loaded with ``strict=True``."""
        from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

        self.model.load_state_dict(load_torch_state_dict(path), strict=True)


class ImprovedMiniCausalVAD(MiniCausalVAD):
    """The ``avenue_training_script2.py:107-297`` interface: the plateau
    scheduler stepped once an epoch on the average loss; the 8-metric
    eval dict."""

    def __init__(self, device=None, cfg: Optional[ExperimentConfig] = None):
        super().__init__(device, cfg or preset("avenue_improved"))
        self.anomaly_weight = self.cfg.loss.anomaly_weight
        self.causal_weight = self.cfg.loss.causal_weight
        self.sparsity_weight = self.cfg.loss.sparsity_weight
        self.consistency_weight = self.cfg.loss.consistency_weight

    def compute_improved_loss(self, anomaly_scores, causal_adj, targets,
                              features=None):
        """The family-D loss of given scores, graphs and targets:
        (total, components) as floats."""
        from cvad_tpu_torch.ops.losses import improved_loss

        def put(x):
            return torch.as_tensor(_host(x), dtype=torch.float32,
                                   device=self.device)

        total, comps = improved_loss(put(anomaly_scores), put(causal_adj),
                                     put(targets).reshape(-1), self.cfg.loss)
        return float(total), {k: float(v) for k, v in comps.items()}

    def train_epoch_improved(self, dataloader: Iterable):
        avg_loss, comps = self.train_epoch(dataloader)
        set_lr(self.state.opt_state, self.scheduler.step(avg_loss))
        return avg_loss, comps

    def evaluate_improved(self, dataloader: Iterable):
        predictions, _, causal_graphs = self.evaluate(dataloader)
        eval_metrics = family_d_eval_metrics(predictions, causal_graphs,
                                             self.cfg.loss.edge_threshold)
        return predictions, causal_graphs, eval_metrics


def create_unsupervised_labels(test_loader: Iterable, model: MiniCausalVAD,
                               threshold_percentile: float = 95):
    """(scores, pseudo-labels, threshold): 1 where a clip's score lies
    above the scores' `threshold_percentile`-th percentile
    (``avenue_training_script1.py:36-67``)."""
    scores = [model._eval_outputs(item)["predictions"].reshape(-1)
              for item in test_loader]
    all_scores = (torch.cat(scores).cpu().numpy().astype(np.float64)
                  if scores else np.zeros(0))
    threshold = float(np.percentile(all_scores, threshold_percentile))
    pseudo = (all_scores > threshold).astype(float)
    return all_scores, pseudo, threshold


def train_minicausal_vad_on_avenue(dataset_path: str, num_epochs: int = 50,
                                   batch_size: int = 4,
                                   learning_rate: float = 0.001,
                                   save_interval: int = 10,
                                   output_dir: str = "avenue_training_results",
                                   loaders=None, device=None):
    """Avenue driver v1 (``avenue_training_script1.py:69-226``): v1 history
    schema, eval every 5 epochs, best by mean score; on `device` (CUDA by
    default)."""
    from cvad_tpu_torch.data.datasets import create_avenue_dataloaders

    train_loader, test_loader = (loaders if loaders is not None else
                                 create_avenue_dataloaders(
                                     dataset_path, batch_size=batch_size))
    model = MiniCausalVAD(device=device)
    if learning_rate != 0.001:
        for pg in model.optimizer.param_groups:
            pg["lr"] = learning_rate

    history = {"train_losses": [], "loss_components": [],
               "evaluation_scores": [], "causal_sparsity": [],
               "epochs": [], "timestamps": []}
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    best_score = 0.0
    for epoch in range(num_epochs):
        train_loss, comps = model.train_epoch(train_loader)
        history["train_losses"].append(train_loss)
        history["loss_components"].append(comps)
        history["epochs"].append(epoch + 1)
        history["timestamps"].append(datetime.now().isoformat())
        if epoch % 5 == 0 or epoch == num_epochs - 1:
            predictions, _, causal_graphs = model.evaluate(test_loader)
            eval_score = (float(np.mean(predictions)) if len(predictions)
                          else train_loss)
            avg_edges = (float(np.mean((causal_graphs > 0.1).sum(
                axis=(1, 2)))) if len(causal_graphs) else 0.0)
            sparsity = (avg_edges / (causal_graphs.shape[1] ** 2)
                        if len(causal_graphs) else 0.0)
            history["evaluation_scores"].append(eval_score)
            history["causal_sparsity"].append(sparsity)
            if eval_score > best_score:
                best_score = eval_score
                model.save_model(str(out / "best_model.pth"))
        if epoch % save_interval == 0:
            model.save_model(str(out / f"checkpoint_epoch_{epoch}.pth"))
        safe_json_save(history, out / "training_history.json", verbose=False)
    return model, history


def train_improved_minicausal_vad(dataset_path: str, num_epochs: int = 100,
                                  batch_size: int = 4, save_interval: int = 20,
                                  output_dir: str = "improved_avenue_results",
                                  loaders=None, device=None):
    """Avenue driver v2 (``avenue_training_script2.py:339-468``): v2 history
    schema, eval every 5 epochs, best by score_range; on `device` (CUDA by
    default)."""
    from cvad_tpu_torch.data.datasets import create_avenue_dataloaders

    train_loader, test_loader = (loaders if loaders is not None else
                                 create_avenue_dataloaders(
                                     dataset_path, batch_size=batch_size))
    model = ImprovedMiniCausalVAD(device=device)
    history = {"train_losses": [], "loss_components": [],
               "evaluation_metrics": [], "epochs": [], "learning_rates": []}
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    best_score_range = 0.0
    for epoch in range(num_epochs):
        train_loss, comps = model.train_epoch_improved(train_loader)
        history["train_losses"].append(train_loss)
        history["loss_components"].append(comps)
        history["epochs"].append(epoch + 1)
        history["learning_rates"].append(
            model.optimizer.param_groups[0]["lr"])
        if epoch % 5 == 0 or epoch == num_epochs - 1:
            _, _, eval_metrics = model.evaluate_improved(test_loader)
            history["evaluation_metrics"].append(eval_metrics)
            if eval_metrics["score_range"] > best_score_range:
                best_score_range = eval_metrics["score_range"]
                model.save_model(str(out / "best_improved_model.pth"))
        if epoch % save_interval == 0:
            model.save_model(str(out / f"checkpoint_epoch_{epoch}.pth"))
        safe_json_save(history, out / "improved_training_history.json",
                       verbose=False)
    return model, history


def setup_training_environment(device=None) -> torch.device:
    """The drivers' device probe (``avenue_training_script1.py:23-35``):
    the `torch.device` they pass to ``MiniCausalVAD(device=...)``, after
    printing the card's name and memory and emptying the allocator's
    cache, as the reference did; CUDA unless `device` says otherwise
    (`resolve_device`: no card raises)."""
    dev = resolve_device(device)
    print(f"Using device: {dev}")
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        print(f"GPU: {props.name}")
        print(f"Memory: {props.total_memory / 1e9:.1f} GB")
        torch.cuda.empty_cache()
    return dev


def test_trained_model(model_path: str, dataset_path: str, loaders=None,
                       device=None):
    """The evaluation driver (``avenue_training_script1.py:293-313``):
    load a checkpoint into `MiniCausalVAD`, evaluate it on the Avenue test
    split, return ``(predictions, causal_graphs)``."""
    from cvad_tpu_torch.data.datasets import create_avenue_dataloaders

    _, test_loader = (loaders if loaders is not None else
                      create_avenue_dataloaders(dataset_path, batch_size=4))
    model = MiniCausalVAD(device=setup_training_environment(device))
    model.load_model(model_path)
    predictions, _, causal_graphs = model.evaluate(test_loader)
    avg_edges = (float(np.mean((causal_graphs > 0.1).sum(axis=(1, 2))))
                 if len(causal_graphs) else 0.0)
    print(f"Predictions: {predictions.shape}, range "
          f"[{predictions.min():.4f}, {predictions.max():.4f}], "
          f"avg causal edges {avg_edges:.1f}")
    return predictions, causal_graphs


test_trained_model.__test__ = False  # reference-named API, not a pytest test
