"""The training engine of the port: families D, C, B and A on one device.

Port of `cvad_tpu/train/engine.py` (`Trainer`: `init_state`, `train_epoch`,
`evaluate`, `_eval_metrics`, `fit`, `restore` with the 'mid' resume,
`_maybe_save_best`, `_save_mid`; and `make_loaders`).  Each step's metrics
are stacked into one device vector (keys sorted, as in `cvad_tpu`, so
history files compare) and summed on the device; the host fetches the sum
once per epoch, and otherwise only every ``log_every`` steps.

Each host batch is copied to the device with a plain ``.to(device)``
(pageable memory, on the current stream): pinned staging on a side stream
(`DevicePrefetcher`) waits for ROADMAP Queue 1 item 15.  Not ported, and
refused where a config asks for them: ``steps_per_call > 1`` (item 5) and
``device_cache='on'`` (item 15); ``device_cache='auto'`` resolves to off.
There is no device mesh: the port trains on one device (item 14).
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from cvad_tpu_torch.config import ExperimentConfig, TrainConfig, family_of
from cvad_tpu_torch.data.batcher import BatchLoader
from cvad_tpu_torch.evaluation.metrics import (family_a_eval_metrics,
                                               family_b_eval_metrics,
                                               family_c_eval_metrics,
                                               family_d_eval_metrics)
from cvad_tpu_torch.runtime.checkpoint import CheckpointManager
from cvad_tpu_torch.runtime.device import resolve_device
from cvad_tpu_torch.runtime.history import TrainingHistory
from cvad_tpu_torch.runtime.metrics import MetricLogger, StepTimer
from cvad_tpu_torch.train.optim import HostScheduler, set_lr
from cvad_tpu_torch.train.tasks import build_task


def check_ported(train: TrainConfig) -> None:
    """Raise for the `TrainConfig` knobs the port does not have yet."""
    if train.steps_per_call != 1:
        raise NotImplementedError(
            "train.steps_per_call > 1 (K steps per call) is not ported yet: "
            "ROADMAP Queue 1 item 5")
    if train.device_cache == "on":
        raise NotImplementedError(
            "train.device_cache='on' (the device clip cache) is not ported "
            "yet: ROADMAP Queue 1 item 15")
    if train.device_cache not in ("auto", "off"):
        raise ValueError(f"unknown train.device_cache "
                         f"{train.device_cache!r}")


class Trainer:
    """End-to-end trainer for one `ExperimentConfig` on one device (CUDA
    unless ``device='cpu'``)."""

    def __init__(self, cfg: ExperimentConfig, out_dir: Optional[str] = None,
                 device=None):
        check_ported(cfg.train)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.task = build_task(cfg)
        self.out_dir = Path(out_dir or cfg.train.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.history = TrainingHistory(self.out_dir / cfg.train.history_name)
        self.logger = MetricLogger(self.out_dir / "metrics.jsonl")
        self.scheduler = HostScheduler(cfg.optim, cfg.train.num_epochs)
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints")
        self.state = None
        self._seed = cfg.train.seed + 1  # the step generators' seed
        self._metric_keys: Optional[list] = None
        self._best = None
        self._since_best = 0  # early-stop counter; checkpointed with _best
        self._mid_resume = None  # set by restore() from a 'mid' checkpoint

    # -- setup ---------------------------------------------------------------

    def init_state(self) -> None:
        """Fresh parameters from ``train.seed`` on the trainer's device."""
        self.state = self.task.init_state(self.cfg.train.seed, self.device)

    def put_batch(self, host_batch: Mapping[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """Copy a host batch to the device (pageable memory)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host_batch.items()}

    def restore(self, step="latest") -> Optional[int]:
        """Restore state, history, scheduler and the best-metric watermark
        from a checkpoint.  'latest' takes the newest step checkpoint, or
        the 'mid' one when it belongs to a later epoch (the interrupted
        epoch then resumes at the exact batch).  Returns the restored epoch,
        or None when there is no checkpoint."""
        if self.state is None:
            self.init_state()
        self._mid_resume = None
        if step == "latest":
            step = self.ckpt.latest_step()
            mid = (self.ckpt.restore_history("mid") or {}).get("_mid")
            if mid and (step is None or int(mid["epoch"]) > step):
                step = "mid"
        if step is None:
            return None
        self.state.load_state_dict(self.ckpt.restore(step))
        hist = self.ckpt.restore_history(step)
        if hist:
            self._mid_resume = hist.pop("_mid", None)
            sched = hist.pop("_scheduler", None)
            self._best = hist.pop("_best", None)
            self._since_best = int(hist.pop("_since_best", 0) or 0)
            for k in self.history.KEYS:
                self.history.data[k] = list(hist.get(k, []))
            if sched:
                self.scheduler.load_state_dict(sched)
                self.state.opt_state = set_lr(self.state.opt_state,
                                              self.scheduler.lr)
        return step if isinstance(step, int) else self.history.last_epoch

    def _ckpt_payload(self) -> Dict:
        return {**self.history.as_dict(),
                "_scheduler": self.scheduler.state_dict(),
                "_best": self._best,
                "_since_best": self._since_best}

    def _save_mid(self, epoch: int, count: int, total_vec: torch.Tensor
                  ) -> None:
        """Rolling preemption checkpoint: the state plus the in-progress
        epoch's batch index and partial metric sum, so `restore` + `fit`
        continue the epoch at the exact batch."""
        payload = {**self._ckpt_payload(),
                   "_mid": {"epoch": int(epoch), "count": int(count),
                            "metric_vec": [float(x) for x in
                                           total_vec.cpu().numpy()]}}
        self.ckpt.save("mid", self.state, history=payload)

    # -- epochs --------------------------------------------------------------

    def train_epoch(self, loader: Iterable[Mapping[str, np.ndarray]],
                    epoch: int, record: bool = True, skip_batches: int = 0,
                    initial: Optional[Mapping] = None) -> Dict[str, float]:
        assert self.state is not None, "call init_state first"
        count = 0
        timer = StepTimer()
        total_vec = None  # device accumulator: no per-step host sync
        # the shuffle follows the global epoch, so a resumed run replays the
        # interrupted run's batch order
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        source: Iterable = loader
        if skip_batches:
            source = (loader.iter_from(skip_batches)
                      if hasattr(loader, "iter_from")
                      else itertools.islice(iter(loader), skip_batches, None))
        if initial is not None:  # restored partial metric sum
            total_vec = torch.from_numpy(np.asarray(
                initial["metric_vec"], np.float32)).to(self.device)
            count = int(initial["count"])
        save_every = self.cfg.train.save_every_steps if record else 0
        next_save = (count // save_every + 1) * save_every if save_every else 0
        for host_batch in source:
            batch = self.put_batch(host_batch)
            self.state, metrics = self.task.train_step(self.state, batch,
                                                       self._seed)
            if self._metric_keys is None:
                self._metric_keys = sorted(metrics)
            vec = torch.stack([metrics[k].float() for k in self._metric_keys])
            total_vec = vec if total_vec is None else total_vec + vec
            count += 1
            if next_save and count >= next_save:
                self._save_mid(epoch, count, total_vec)
                next_save = (count // save_every + 1) * save_every
            t = timer.tick()
            if count % self.cfg.train.log_every == 0:
                host = dict(zip(self._metric_keys, vec.cpu().numpy()))
                self.logger.log("train_batch", epoch=epoch, batch=count,
                                **host, steps_per_s=t["steps_per_s"])
        if total_vec is None:
            avg: Dict[str, float] = {}
        else:
            vals = total_vec.cpu().numpy() / max(count, 1)  # one fetch
            avg = {k: float(v) for k, v in zip(self._metric_keys, vals)}
        if not record:
            return avg
        lr = self.scheduler.lr
        self.history.record_epoch(epoch, avg.get("loss", float("nan")),
                                  {k: v for k, v in avg.items()
                                   if k != "loss"}, lr)
        # epoch-granular schedule, then the new lr into the optimizer state
        new_lr = self.scheduler.step(avg.get("loss"))
        if new_lr != lr:
            self.state.opt_state = set_lr(self.state.opt_state, new_lr)
            self.logger.log("lr_update", epoch=epoch, lr=new_lr)
        return avg

    def evaluate(self, loader: Iterable[Mapping[str, np.ndarray]]
                 ) -> Dict[str, Any]:
        """Eval step over every batch; outputs stay on the device until one
        fetch at the end."""
        outs: Dict[str, list] = {}
        for host_batch in loader:
            out = self.task.eval_step(self.state, self.put_batch(host_batch))
            for k, v in out.items():
                outs.setdefault(k, []).append(v)
        merged = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        return self._eval_metrics(merged)

    def _eval_metrics(self, out: Mapping[str, np.ndarray]) -> Dict[str, Any]:
        family = family_of(self.cfg.model)
        if family in ("b", "c"):
            metrics = (family_b_eval_metrics if family == "b"
                       else family_c_eval_metrics)
            m = metrics(out["predictions"], out["labels"], out["loss"])
            keep = ("predictions", "labels")
        elif family == "a":
            m = family_a_eval_metrics(out["predictions"], out["labels"],
                                      out["direct_predictions"])
            keep = ("predictions", "causal_scores", "direct_predictions",
                    "labels")
        else:
            m = family_d_eval_metrics(out["predictions"], out["causal_graphs"],
                                      self.cfg.loss.edge_threshold)
            keep = ("predictions", "causal_graphs")
        return {**m, **{k: out[k] for k in keep}}

    # -- full run ------------------------------------------------------------

    def fit(self, train_loader, eval_loader=None) -> Dict:
        cfg = self.cfg.train
        if self.state is None:
            self.init_state()
        t0 = time.time()
        start_epoch = self.history.last_epoch + 1
        trained_any = False
        for epoch in range(start_epoch, cfg.num_epochs + 1):
            trained_any = True
            mid = self._mid_resume
            if mid is not None and int(mid["epoch"]) == epoch:
                self._mid_resume = None  # applies to this epoch only
                avg = self.train_epoch(train_loader, epoch,
                                       skip_batches=int(mid["count"]),
                                       initial=mid)
            else:
                avg = self.train_epoch(train_loader, epoch)
            self.logger.log("epoch", epoch=epoch, **avg)
            is_eval = (eval_loader is not None
                       and ((epoch - 1) % cfg.eval_every == 0
                            or epoch == cfg.num_epochs))
            if is_eval:
                metrics = self.evaluate(eval_loader)
                scalar = {k: v for k, v in metrics.items()
                          if isinstance(v, (int, float))}
                self.history.record_eval(scalar)
                self.logger.log("eval", epoch=epoch, **scalar)
                improved = self._maybe_save_best(epoch, scalar, avg)
                self._since_best = 0 if improved else self._since_best + 1
                if (cfg.early_stop_patience
                        and self._since_best >= cfg.early_stop_patience):
                    self.logger.log("early_stop", epoch=epoch,
                                    patience=cfg.early_stop_patience)
                    break
            if cfg.save_interval and epoch % cfg.save_interval == 0:
                self.ckpt.save(int(epoch), self.state,
                               history=self._ckpt_payload())
        if cfg.reload_best and self.ckpt.path("best").is_file():
            self.state.load_state_dict(self.ckpt.restore("best"))
            self.logger.log("reloaded_best", best=self._best)
        if cfg.save_every_steps and trained_any:
            # the run completed and trained: drop the rolling snapshot, so a
            # later restore cannot replay the last epoch's tail from it
            self.ckpt.remove("mid")
        self.logger.log("done", epochs=cfg.num_epochs,
                        total_s=time.time() - t0)
        return self.history.as_dict()

    def _maybe_save_best(self, epoch: int, eval_metrics: Mapping[str, float],
                         train_avg: Mapping[str, float]) -> bool:
        cfg = self.cfg.train
        key = cfg.best_metric
        value = eval_metrics.get(key, train_avg.get(key))
        if value is None or not np.isfinite(value):
            return False
        better = (self._best is None
                  or (cfg.best_mode == "max" and value > self._best)
                  or (cfg.best_mode == "min" and value < self._best))
        if better:
            self._best = value
            self.ckpt.save("best", self.state, history=self._ckpt_payload())
            self.logger.log("best_model", epoch=epoch, **{key: value})
        return better


def make_loaders(cfg: ExperimentConfig, n_synthetic: int = 256):
    """(train_loader, eval_loader) from the data config: the train split
    shuffled, the test split (half as many clips, at least 2) in order."""
    from cvad_tpu_torch.data.datasets import build_dataset

    train = build_dataset(cfg.data, "Train", n_synthetic)
    test = build_dataset(cfg.data, "Test", max(n_synthetic // 2, 2))
    bs = cfg.data.batch_size
    return (BatchLoader(train, bs, shuffle=True, seed=cfg.data.seed,
                        num_threads=cfg.data.num_decode_threads,
                        prefetch=cfg.data.prefetch,
                        transfer_dtype=cfg.data.transfer_dtype),
            BatchLoader(test, bs, shuffle=False,
                        num_threads=cfg.data.num_decode_threads,
                        prefetch=cfg.data.prefetch,
                        transfer_dtype=cfg.data.transfer_dtype))
