"""The training engine of the port: families D, C, B and A on one device.

Port of `cvad_tpu/train/engine.py` (`Trainer`: `init_state`, `put_batch`,
`put_chunk`, `_clip_cache`, `train_epoch` with K steps per call,
`evaluate`, `_eval_metrics`, `fit`, `restore` with the 'mid' resume,
`_maybe_save_best`, `_save_mid`; `_chunk_batches` and `make_loaders`).
Each step's metrics are stacked into one device vector (keys sorted, as in
`cvad_tpu`, so history files compare) and summed on the device; the host
fetches the sum once per epoch, and otherwise only where ``log_every``
falls.

Every batch the engine feeds carries the ``valid`` loss mask, all ones on
one device, as `cvad_tpu`'s do.  The feed is the device clip cache
(`data/device_cache.py`) where ``train.device_cache`` allows it, else the
host loader through `DevicePrefetcher` (pinned staging, a side stream).
With ``train.steps_per_call`` = K > 1, full chunks of K equal-shaped
batches go to `train/graphs.py::MultiStep` (one CUDA graph replay for K
steps on the card), and the remainder and odd shapes run singly.
There is no device mesh: the port trains on one device (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

import itertools
import time
import weakref
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional

import numpy as np
import torch

from cvad_tpu_torch.config import ExperimentConfig, family_of
from cvad_tpu_torch.data.batcher import (BatchLoader, DevicePrefetcher,
                                         with_valid)
from cvad_tpu_torch.evaluation.metrics import (family_a_eval_metrics,
                                               family_b_eval_metrics,
                                               family_c_eval_metrics,
                                               family_d_eval_metrics)
from cvad_tpu_torch.runtime.checkpoint import CheckpointManager
from cvad_tpu_torch.runtime.device import resolve_device
from cvad_tpu_torch.runtime.history import TrainingHistory
from cvad_tpu_torch.runtime.metrics import MetricLogger, StepTimer
from cvad_tpu_torch.train.graphs import MultiStep
from cvad_tpu_torch.train.optim import HostScheduler, set_lr
from cvad_tpu_torch.train.tasks import build_task


class Trainer:
    """End-to-end trainer for one `ExperimentConfig` on one device (CUDA
    unless ``device='cpu'``)."""

    def __init__(self, cfg: ExperimentConfig, out_dir: Optional[str] = None,
                 device=None):
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
        self._multi = MultiStep(self.task, self._seed)  # K steps a call
        self._device_caches: Dict[int, Any] = {}  # id(loader) -> (ref, cache)

    # -- setup ---------------------------------------------------------------

    def init_state(self) -> None:
        """Fresh parameters from ``train.seed`` on the trainer's device."""
        self.state = self.task.init_state(self.cfg.train.seed, self.device)

    def put_batch(self, host_batch: Mapping[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """A host batch with its ``valid`` mask, copied to the device (the
        tensors `DevicePrefetcher` yields for it, without its overlap)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in with_valid(host_batch).items()}

    def put_chunk(self, host_batches: List[Mapping[str, np.ndarray]]
                  ) -> Dict[str, torch.Tensor]:
        """Equal-shaped host batches stacked into one (K, B, ...) device
        chunk for the K-step call."""
        batches = [with_valid(b) for b in host_batches]
        return {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(
            self.device) for k in batches[0]}

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
                set_lr(self.state.opt_state, self.scheduler.lr)
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

    def _clip_cache(self, loader, strict: Optional[bool] = None):
        """The loader's `DeviceClipCache` where ``train.device_cache`` and
        eligibility allow one, built once a loader and reused every epoch.
        `strict` (default: mode 'on') raises for an ineligible loader;
        `evaluate` passes False, so that an ineligible eval split runs
        uncached instead of ending the run at its first eval."""
        mode = self.cfg.train.device_cache
        if strict is None:
            strict = mode == "on"
        if mode == "off" or not hasattr(loader, "epoch_index_batches"):
            if strict and mode == "on":
                raise ValueError(
                    "train.device_cache='on' needs a BatchLoader-style "
                    "loader exposing epoch_index_batches")
            return None
        # keyed by id() and checked through a weakref: a dead loader's id
        # can be reused by a new one
        key = id(loader)
        entry = self._device_caches.get(key)
        if entry is not None and entry[0]() is loader:
            return entry[1]
        from cvad_tpu_torch.data.device_cache import (DeviceClipCache,
                                                      cache_eligible)

        # one budget for every cache this trainer holds
        reserved = sum(c.nbytes for _, c in self._device_caches.values()
                       if c is not None)
        frac = self.cfg.train.device_cache_hbm_frac
        if not cache_eligible(loader, frac, self.device,
                              reserved_bytes=reserved):
            if strict and mode == "on":
                raise ValueError(
                    "train.device_cache='on' but the loader is ineligible "
                    "(needs transfer_dtype='uint8', a get_uint8 dataset, "
                    f"the native layout, and the split to fit {frac:.0%} of "
                    "device memory alongside existing caches)")
            self._device_caches[key] = (weakref.ref(loader), None)
            return None
        t0 = time.perf_counter()
        cache = DeviceClipCache(loader, self.device)
        self._device_caches[key] = (weakref.ref(loader), cache)
        self.logger.log("device_cache", clips=len(loader.dataset),
                        mbytes=round(cache.nbytes / 1e6, 1),
                        fill_s=time.perf_counter() - t0)
        return cache

    def _feed(self, loader, epoch: int, skip: int
              ) -> Iterator[Dict[str, torch.Tensor]]:
        """The epoch's device batches: from the clip cache, or from the
        host loader through `DevicePrefetcher`; (K, B, ...) chunks where
        ``steps_per_call`` = K > 1, single batches otherwise."""
        k = self.cfg.train.steps_per_call
        cache = self._clip_cache(loader)
        if cache is not None:  # the cache pins the epoch itself
            return cache.device_batches(epoch, k, skip=skip)
        # the shuffle follows the global epoch, so a resumed run replays
        # the interrupted run's batch order
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        source: Iterable = loader
        if skip:
            source = (loader.iter_from(skip) if hasattr(loader, "iter_from")
                      else itertools.islice(iter(loader), skip, None))
        host = (_chunk_batches(source, k) if k > 1
                else (with_valid(b) for b in source))
        return iter(DevicePrefetcher(host, self.device))

    def train_epoch(self, loader: Iterable[Mapping[str, np.ndarray]],
                    epoch: int, record: bool = True, skip_batches: int = 0,
                    initial: Optional[Mapping] = None) -> Dict[str, float]:
        assert self.state is not None, "call init_state first"
        count = 0
        timer = StepTimer()
        total_vec = None  # device accumulator: no per-step host sync
        if initial is not None:  # restored partial metric sum
            total_vec = torch.from_numpy(np.asarray(
                initial["metric_vec"], np.float32)).to(self.device)
            count = int(initial["count"])
        count0 = count
        save_every = self.cfg.train.save_every_steps if record else 0
        next_save = (count // save_every + 1) * save_every if save_every else 0
        log_every = self.cfg.train.log_every
        for batch in self._feed(loader, epoch, skip_batches):
            if batch["clips"].dim() == 6:  # a (K, B, ...) chunk
                vec, total_vec, keys = self._multi(self.state, batch,
                                                   total_vec)
                dk = batch["clips"].shape[0]
            else:
                self.state, metrics = self.task.train_step(
                    self.state, batch, self._seed)
                keys = sorted(metrics)
                vec = torch.stack([metrics[k].float() for k in keys])
                total_vec = vec if total_vec is None else total_vec + vec
                dk = 1
            if self._metric_keys is None:
                self._metric_keys = keys
            count += dk
            # 'mid' checkpoints and log lines fall at dispatch boundaries
            if next_save and count >= next_save:
                self._save_mid(epoch, count, total_vec)
                next_save = (count // save_every + 1) * save_every
            t = timer.tick()
            if count // log_every > (count - dk) // log_every:
                host = dict(zip(self._metric_keys, vec.cpu().numpy() / dk))
                self.logger.log("train_batch", epoch=epoch, batch=count,
                                **host, steps_per_s=(count - count0)
                                / max(t["elapsed_s"], 1e-9))
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
            set_lr(self.state.opt_state, new_lr)
            self.logger.log("lr_update", epoch=epoch, lr=new_lr)
        return avg

    def evaluate(self, loader: Iterable[Mapping[str, np.ndarray]]
                 ) -> Dict[str, Any]:
        """Eval step over every batch; outputs stay on the device until one
        fetch at the end.  An unshuffled loader feeds from the clip cache
        where one is allowed (its order is then the dataset's, which the
        cache replays)."""
        cache = (self._clip_cache(loader, strict=False)
                 if not getattr(loader, "shuffle", True) else None)
        feed = (cache.device_batches(0, 1) if cache is not None
                else DevicePrefetcher((with_valid(b) for b in loader),
                                      self.device))
        outs: Dict[str, list] = {}
        for batch in feed:
            out = self.task.eval_step(self.state, batch)
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


def _chunk_batches(loader: Iterable[Mapping[str, np.ndarray]], k: int
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Group equal-shaped host batches, each with its ``valid`` mask, into
    stacked (K, B, ...) chunks for the K-step call; odd-shaped and
    remainder batches pass through singly (`cvad_tpu`'s, on one device)."""
    pending: List[Dict[str, np.ndarray]] = []
    shape = None
    for batch in loader:
        batch = with_valid(batch)
        s = batch["clips"].shape
        if shape is not None and s != shape and pending:
            yield from pending  # the shape changed: flush singly
            pending = []
        shape = s
        pending.append(batch)
        if len(pending) == k:
            yield {key: np.stack([b[key] for b in pending])
                   for key in pending[0]}
            pending = []
    yield from pending


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
