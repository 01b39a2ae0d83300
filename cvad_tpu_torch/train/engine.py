"""The training engine of the port: families D, C, B and A, on one device
or over the ranks of a mesh.

Port of `cvad_tpu/train/engine.py` (`Trainer`: `init_state`, `put_batch`,
`put_chunk`, `_clip_cache`, `train_epoch` with K steps per call,
`evaluate`, `_eval_metrics`, `fit`, `restore` with the 'mid' resume,
`_maybe_save_best`, `_save_mid`; `_chunk_batches` and `make_loaders`).
Each step's metrics are stacked into one device vector (keys sorted, as in
`cvad_tpu`, so history files compare) and summed on the device; the host
fetches the sum once per epoch, and otherwise only where ``log_every``
falls.

The mesh (`runtime/mesh.py`, `cvad_tpu`'s :40-44) comes from
``cfg.parallel`` over the initialised process group (the trivial 1 x 1
mesh without one).  Every batch the engine feeds is padded to a multiple
of the data axis and carries the ``valid`` loss mask (`pad_with_valid`,
all ones where nothing is padded), as `cvad_tpu`'s do; each rank then
takes its rows, and on a time axis its frames (`shard_batch`).  Every rank
loads the global batch, or, from a `runtime/multihost.py::make_host_loader`
loader, only its own rows.  The feed is the device clip cache
(`data/device_cache.py`, on every rank, gathering the rank's rows) where
``train.device_cache`` allows it, else the host loader through
`DevicePrefetcher` (pinned staging, a side stream).  With
``train.steps_per_call`` = K > 1, full chunks of K equal-shaped batches go
to `train/graphs.py::MultiStep` (one CUDA graph replay for K steps on the
card, the collectives captured in it), and the remainder and odd shapes
run singly.  `evaluate` gathers every rank's outputs and drops the padded
rows.  Rank 0 alone writes the checkpoints, the history and
``metrics.jsonl``, and every rank waits for each write; `restore` reads
on every rank.  `train_epoch` names its parts on the profiler's clock
(`runtime/metrics.py::span`): ``trainer.feed`` (the next batch or chunk),
``trainer.step`` (the step's or the graph replay's issue), ``trainer.log``
and ``trainer.epoch_end`` (``trainer.fetch``, ``trainer.history``,
``trainer.schedule``).
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
from cvad_tpu_torch.data.batcher import BatchLoader, DevicePrefetcher
from cvad_tpu_torch.evaluation.metrics import (family_a_eval_metrics,
                                               family_b_eval_metrics,
                                               family_c_eval_metrics,
                                               family_d_eval_metrics)
from cvad_tpu_torch.runtime.checkpoint import CheckpointManager
from cvad_tpu_torch.runtime.device import resolve_device
from cvad_tpu_torch.runtime.history import TrainingHistory
from cvad_tpu_torch.runtime.mesh import (Mesh, create_mesh, pad_with_valid,
                                         shard_batch)
from cvad_tpu_torch.runtime.metrics import MetricLogger, span
from cvad_tpu_torch.train.graphs import MultiStep
from cvad_tpu_torch.train.optim import HostScheduler, set_lr
from cvad_tpu_torch.train.tasks import build_task


class Trainer:
    """End-to-end trainer for one `ExperimentConfig` on this rank's device
    (CUDA unless ``device='cpu'``; ``cuda:LOCAL_RANK`` under a process
    group) over `mesh` (by default `create_mesh` from ``cfg.parallel``)."""

    def __init__(self, cfg: ExperimentConfig, mesh: Optional[Mesh] = None,
                 out_dir: Optional[str] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else create_mesh(
            cfg.parallel.data_axis, cfg.parallel.temporal_axis)
        self.task = build_task(cfg, self.mesh)
        # clips shard their T axis (dim 1) where the mesh has a time axis
        self._time_dim = 1 if self.mesh.shape["time"] > 1 else None
        primary = self.mesh.primary
        self.out_dir = Path(out_dir or cfg.train.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.history = TrainingHistory(
            self.out_dir / cfg.train.history_name if primary else None)
        self.logger = MetricLogger(
            self.out_dir / "metrics.jsonl" if primary else None,
            echo=primary)
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

    def _to_device(self, batch: Mapping[str, np.ndarray], lead: int = 0
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in shard_batch(self.mesh, batch, self._time_dim,
                                        lead).items()}

    def put_batch(self, host_batch: Mapping[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """A global host batch padded to the data axis with its ``valid``
        mask, this rank's part of it on the device (what `DevicePrefetcher`
        yields for it, without its overlap)."""
        return self._to_device(pad_with_valid(host_batch,
                                              self.mesh.shape["data"]))

    def put_chunk(self, host_batches: List[Mapping[str, np.ndarray]]
                  ) -> Dict[str, torch.Tensor]:
        """Equal-shaped global host batches, each padded with its mask,
        stacked into one (K, B, ...) chunk for the K-step call: this rank's
        part on the device."""
        nd = self.mesh.shape["data"]
        batches = [pad_with_valid(b, nd) for b in host_batches]
        return self._to_device({k: np.stack([b[k] for b in batches])
                                for k in batches[0]}, lead=1)

    def _save(self, step, history: Mapping) -> None:
        """A checkpoint written by rank 0, every rank waiting for it."""
        if self.mesh.primary:
            self.ckpt.save(step, self.state, history=history)
        self.mesh.barrier(self.device)

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
        self._save("mid", payload)

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
        cache = DeviceClipCache(loader, self.device, self.mesh,
                                self._time_dim)
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
        return iter(self._prefetch(loader, source, k))

    def _prefetch(self, loader, source: Iterable, k: int) -> DevicePrefetcher:
        """`source`'s batches padded with their masks (chunked where `k` >
        1) and this rank's part of each copied ahead to the device.  A
        `make_host_loader` loader yields this rank's rows already, as many
        as every other rank's where the process count divides its global
        batch (checked here, with no collective: the copy runs in a
        thread), and they are not sharded again."""
        if getattr(loader, "host_local", False):
            nd = self.mesh.shape["data"]
            if self._time_dim is not None or loader.global_batch % nd:
                raise ValueError(
                    "a host-sharded loader needs parallel.temporal_axis=1 "
                    f"and a global batch ({loader.global_batch}) that its "
                    f"{nd} ranks divide")
            nd, mesh = 1, None
        else:
            nd, mesh = self.mesh.shape["data"], self.mesh
        if k > 1:
            return DevicePrefetcher(_chunk_batches(source, k, nd),
                                    self.device, mesh=mesh,
                                    time_dim=self._time_dim)
        return DevicePrefetcher(source, self.device, mesh=mesh,
                                pad_to_multiple=nd, time_dim=self._time_dim)

    def train_epoch(self, loader: Iterable[Mapping[str, np.ndarray]],
                    epoch: int, record: bool = True, skip_batches: int = 0,
                    initial: Optional[Mapping] = None) -> Dict[str, float]:
        assert self.state is not None, "call init_state first"
        count = 0
        t0 = time.perf_counter()
        total_vec = None  # device accumulator: no per-step host sync
        if initial is not None:  # restored partial metric sum
            total_vec = torch.from_numpy(np.asarray(
                initial["metric_vec"], np.float32)).to(self.device)
            count = int(initial["count"])
        count0 = count
        save_every = self.cfg.train.save_every_steps if record else 0
        next_save = (count // save_every + 1) * save_every if save_every else 0
        log_every = self.cfg.train.log_every
        feed = self._feed(loader, epoch, skip_batches)
        while True:
            with span("trainer.feed"):
                batch = next(feed, None)
            if batch is None:
                break
            with span("trainer.step"):
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
            if count // log_every > (count - dk) // log_every:
                with span("trainer.log"):
                    host = dict(zip(self._metric_keys, vec.cpu().numpy() / dk))
                    # the clock after the fetch: the steps have run
                    elapsed = time.perf_counter() - t0
                    self.logger.log("train_batch", epoch=epoch, batch=count,
                                    **host, steps_per_s=(count - count0)
                                    / max(elapsed, 1e-9))
        with span("trainer.epoch_end"):
            with span("trainer.fetch"):
                if total_vec is None:
                    avg: Dict[str, float] = {}
                else:
                    vals = total_vec.cpu().numpy() / max(count, 1)  # one fetch
                    avg = {k: float(v)
                           for k, v in zip(self._metric_keys, vals)}
            if not record:
                return avg
            lr = self.scheduler.lr
            with span("trainer.history"):
                self.history.record_epoch(
                    epoch, avg.get("loss", float("nan")),
                    {k: v for k, v in avg.items() if k != "loss"}, lr)
            # epoch-granular schedule, then the new lr into the optimizer
            # state
            with span("trainer.schedule"):
                new_lr = self.scheduler.step(avg.get("loss"))
                if new_lr != lr:
                    set_lr(self.state.opt_state, new_lr)
                    self.logger.log("lr_update", epoch=epoch, lr=new_lr)
        return avg

    def evaluate(self, loader: Iterable[Mapping[str, np.ndarray]]
                 ) -> Dict[str, Any]:
        """Eval step over every batch; outputs, gathered over the data axis
        by the step, stay on the device until one fetch at the end, where
        the padded rows are dropped.  An unshuffled loader feeds from the
        clip cache where one is allowed (its order is then the dataset's,
        which the cache replays)."""
        cache = (self._clip_cache(loader, strict=False)
                 if not getattr(loader, "shuffle", True) else None)
        feed = (cache.device_batches(0, 1) if cache is not None
                else self._prefetch(loader, loader, 1))
        outs: Dict[str, list] = {}
        for batch in feed:
            out = self.task.eval_step(self.state, batch)
            for k, v in out.items():
                outs.setdefault(k, []).append(v)
        merged = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        keep = merged.pop("valid") > 0
        return self._eval_metrics({k: v[keep] for k, v in merged.items()})

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
                self._save(int(epoch), self._ckpt_payload())
        if cfg.reload_best and self.ckpt.path("best").is_file():
            self.state.load_state_dict(self.ckpt.restore("best"))
            self.logger.log("reloaded_best", best=self._best)
        if cfg.save_every_steps and trained_any:
            # the run completed and trained: drop the rolling snapshot, so a
            # later restore cannot replay the last epoch's tail from it
            if self.mesh.primary:
                self.ckpt.remove("mid")
            self.mesh.barrier(self.device)
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
            self._save("best", self._ckpt_payload())
            self.logger.log("best_model", epoch=epoch, **{key: value})
        return better


def _chunk_batches(loader: Iterable[Mapping[str, np.ndarray]], k: int,
                   pad_multiple: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Group equal-shaped host batches, each padded to `pad_multiple` rows
    with its ``valid`` mask, into stacked (K, B, ...) chunks for the K-step
    call; odd-shaped and remainder batches pass through singly
    (`cvad_tpu`'s :574-590)."""
    pending: List[Dict[str, np.ndarray]] = []
    shape = None
    for batch in loader:
        batch = pad_with_valid(batch, pad_multiple)
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
