"""K train steps in one call: the counterpart of `cvad_tpu`'s `multi_step`
(`cvad_tpu/train/engine.py:107-134`, a ``lax.scan`` of the step over K
stacked batches, one dispatch for K steps).

On CUDA, `MultiStep` captures K calls of the task's ``train_step`` into one
``torch.cuda.CUDAGraph`` on static (K, B, ...) input buffers, and each
call copies a chunk of K batches into them and replays the graph: the
host issues one replay for K steps in place of thousands of launches.  On
the CPU the K steps run as a plain loop of the same steps.  Both give what
K single steps give, bit for bit:

- the state: every tensor of it is written in place (`train/state.py`),
  so each replay reads what the last one wrote; ``state.step``, a host
  int, advances by K a replay;
- the draws: each step slot has its own generator, registered with the
  graph and seeded before each replay with ``step_seed(seed, step + i)``,
  the seed an eager step takes; the graph's draws read the seed at replay
  time and start at offset 0, as a fresh generator does;
- the metrics: the graph adds each step's metric vector to the running
  sum in step order (an epoch's first sum starts from -0.0, which adds
  exactly), as the engine's eager loop does, and also returns the chunk's
  own sum.

Before capture one eager step warms up cuBLAS, cuDNN, the autograd
threads and the kernels' builds on the capture stream; it runs on the real
state, which is copied back from a snapshot afterwards, so the warm-up
trains nothing.  Its launches count (they ran).  The kernel wrappers'
launch counters are plain ints bumped in Python, so they count once, at
capture, for launches that have not run: the capture's bumps are taken
back, and each replay adds them again; so do the collectives' call
counters.  Over a mesh the steps' collectives (`parallel/collectives.py`:
the gathers, BatchNorm's all-reduce, the gradient's) are captured with
them, NCCL's kernels recorded into the graph; the warm-up step has set
up the communicator.  A capture that fails
raises with its cause; nothing falls back to eager steps.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

from cvad_tpu_torch.parallel import collectives
from cvad_tpu_torch.train.state import TrainState
from cvad_tpu_torch.train.tasks import card_numerics, step_seed


def launch_counters() -> Dict[str, Tuple[object, str]]:
    """Every kernel wrapper's launch counter and every collective's call
    counter (`parallel/collectives.py`): name -> (object, attribute)."""
    from cvad_tpu_torch.ops.flash_attention import flash_attention
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1
    from cvad_tpu_torch.ops.pallas_kernels import (memory_min_cosine_distance,
                                                   pairwise_l1_mean)
    from cvad_tpu_torch.ops.pallas_s2d import s2d_fold_matmul, s2d_group_conv

    return {"tfold_conv1": (tfold_conv1, "launches"),
            "pairwise_l1_forward": (pairwise_l1_mean, "launches"),
            "pairwise_l1_backward": (pairwise_l1_mean, "backward_launches"),
            "memory_min_cosine": (memory_min_cosine_distance, "launches"),
            "s2d_group_forward": (s2d_group_conv, "launches"),
            "s2d_group_wgrad": (s2d_group_conv, "backward_launches"),
            "s2d_matmul_forward": (s2d_fold_matmul, "launches"),
            "s2d_matmul_dgrad": (s2d_fold_matmul, "dgrad_launches"),
            "s2d_matmul_wgrad": (s2d_fold_matmul, "wgrad_launches"),
            "flash_forward": (flash_attention, "launches"),
            "flash_dq": (flash_attention, "dq_launches"),
            "flash_dkv": (flash_attention, "dkv_launches"),
            **collectives.counters()}


def read_counters() -> Dict[str, int]:
    return {n: getattr(o, a) for n, (o, a) in launch_counters().items()}


def add_counters(delta: Mapping[str, int]) -> None:
    for n, (o, a) in launch_counters().items():
        setattr(o, a, getattr(o, a) + delta.get(n, 0))


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every device tensor of the state: parameters, buffers (BatchNorm
    statistics, family B's bank), both moments, Adam's count, the lr."""
    o = state.opt_state
    return [*state.model.state_dict().values(), o.mu, o.nu, o.count, o.lr]


def _slot(batch: Mapping[str, torch.Tensor], i: int
          ) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batch.items()}


class StepGraph:
    """One captured graph of K train steps on static (K, B, ...) buffers
    shaped like `chunk`, for one state."""

    def __init__(self, task, state: TrainState, seed: int,
                 chunk: Mapping[str, torch.Tensor]):
        self.k = int(chunk["clips"].shape[0])
        self.seed = seed
        dev = chunk["clips"].device
        self.static = {n: torch.empty(v.shape, dtype=v.dtype,
                                      device=dev).copy_(v)
                       for n, v in chunk.items()}
        self.gens = [torch.Generator(device=dev) for _ in range(self.k)]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        step0 = state.step
        with torch.cuda.stream(side), torch.no_grad():
            saved = [t.clone() for t in _state_tensors(state)]
        with torch.cuda.stream(side):
            self.gens[0].manual_seed(step_seed(seed, step0))
            _, metrics = task.train_step(state, _slot(self.static, 0), seed,
                                         gen=self.gens[0])
            self.keys = sorted(metrics)
            with torch.no_grad():
                for t, s in zip(_state_tensors(state), saved):
                    t.copy_(s)
        del saved
        state.step = step0
        self.acc = torch.zeros(len(self.keys), device=dev)
        self.chunk_sum = torch.zeros_like(self.acc)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.gens:
            self.graph.register_generator_state(g)
        before = read_counters()
        try:
            # thread_local: a feed thread may pin host memory meanwhile
            with card_numerics(), torch.cuda.graph(
                    self.graph, stream=side, capture_error_mode="thread_local"):
                total, chunk_sum = self.acc, None
                for i in range(self.k):
                    _, m = task.train_step(state, _slot(self.static, i), seed,
                                           gen=self.gens[i])
                    vec = torch.stack([m[key].float() for key in self.keys])
                    total = total + vec
                    chunk_sum = vec if chunk_sum is None else chunk_sum + vec
                self.acc.copy_(total)
                self.chunk_sum.copy_(chunk_sum)
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.k} train steps into one CUDA graph failed "
                f"(batch {self.shapes(chunk)}): {e}") from e
        finally:
            state.step = step0
            after = read_counters()
            add_counters({n: before[n] - v for n, v in after.items()})
        self.launches = {n: after[n] - before[n] for n in after}
        torch.cuda.current_stream(dev).wait_stream(side)

    @staticmethod
    def shapes(chunk: Mapping[str, torch.Tensor]) -> tuple:
        return tuple((n, tuple(v.shape), v.dtype)
                     for n, v in sorted(chunk.items()))

    def replay(self, state: TrainState, chunk: Mapping[str, torch.Tensor],
               total: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K steps on `chunk` from `state`: (the chunk's metric sum, the
        running sum `total` plus it, step by step)."""
        for n, v in chunk.items():
            self.static[n].copy_(v)
        for i, g in enumerate(self.gens):
            g.manual_seed(step_seed(self.seed, state.step + i))
        if total is None:
            self.acc.fill_(-0.0)
        else:
            self.acc.copy_(total)
        self.graph.replay()
        state.step += self.k
        add_counters(self.launches)
        return self.chunk_sum.clone(), self.acc.clone()


class MultiStep:
    """The K-step call of one task: a captured graph per (K, batch shapes,
    dtypes) on CUDA, reused across epochs; a loop on the CPU."""

    def __init__(self, task, seed: int):
        self.task = task
        self.seed = seed
        self.graphs: Dict[tuple, StepGraph] = {}
        self._state = None  # the state the graphs were captured for

    def __call__(self, state: TrainState, chunk: Mapping[str, torch.Tensor],
                 total: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[str]]:
        """K steps on the stacked `chunk`: (the chunk's metric sum, `total`
        plus the K steps' metric vectors in step order, the metric keys)."""
        if chunk["clips"].device.type != "cuda":
            return self._loop(state, chunk, total)
        if state is not self._state:  # a new state: drop the old graphs
            self.graphs, self._state = {}, state
        key = StepGraph.shapes(chunk)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(self.task, state, self.seed,
                                                 chunk)
        chunk_sum, total = graph.replay(state, chunk, total)
        return chunk_sum, total, graph.keys

    def _loop(self, state: TrainState, chunk: Mapping[str, torch.Tensor],
              total: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, List[str]]:
        chunk_sum, keys = None, None
        for i in range(int(chunk["clips"].shape[0])):
            _, m = self.task.train_step(state, _slot(chunk, i), self.seed)
            keys = sorted(m)
            vec = torch.stack([m[key].float() for key in keys])
            total = vec if total is None else total + vec
            chunk_sum = vec if chunk_sum is None else chunk_sum + vec
        return chunk_sum, total, keys
