"""A data-parallel dry run over gloo CPU processes, and the helper that
starts such a world.

`dryrun_multichip(n)` is the port's counterpart of
`__graft_entry__.py::dryrun_multichip` (:43-80): it spawns `n` processes
that form a gloo process group on the CPU, and each runs one real
data-parallel train step of family D at tiny shapes through the mesh
(`runtime/mesh.py`) and the task's collectives.  Nothing reaches a card.
Every rank checks that the loss is finite and that its parameters equal
rank 0's bit for bit; a rank that fails raises in the caller.

`run_world(fn, n, *args)` is the start-up both use: spawned processes
(``torch.multiprocessing``, the ``spawn`` method), a ``file://``
rendezvous in a fresh temporary directory, ``fn(rank, n, *args)`` on each
with its group started (`multihost.start_group`) and destroyed after, and
a deadline after which every process is killed and the call raises
`TimeoutError`, so a hang fails instead of waiting.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch


def _entry(rank: int, fn: Callable, world: int, init: str,
           args: tuple) -> None:
    import torch.distributed as dist

    from cvad_tpu_torch.runtime.multihost import start_group

    torch.set_num_threads(1)  # tiny shapes; the ranks share the cores
    start_group(rank, world, init, "cpu", timeout_s=120)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, *args, timeout: float = 300.0
              ) -> None:
    """``fn(rank, world, *args)`` on `world` spawned gloo CPU ranks (`fn`
    importable by name, `args` picklable); raises what a rank raised, or
    `TimeoutError` after `timeout` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="cvad_world_") as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        ctx = mp.start_processes(_entry, (fn, world, init, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks of {fn.__name__} still ran after "
                        f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def _dryrun_rank(rank: int, world: int) -> None:
    """One family-D data-parallel step on this rank's rows of a seeded
    global batch of 2 clips a rank (8 frames of 16 x 16), dropout on."""
    import torch.distributed as dist

    from cvad_tpu_torch.config import preset
    from cvad_tpu_torch.runtime.mesh import create_mesh
    from cvad_tpu_torch.train.engine import Trainer

    cfg = preset("family_d")
    cfg = cfg.replace(data=cfg.data.replace(batch_size=2 * world,
                                            frame_size=(16, 16)))
    with tempfile.TemporaryDirectory(prefix="cvad_dryrun_") as tmp:
        tr = Trainer(cfg, mesh=create_mesh(), out_dir=tmp, device="cpu")
        tr.init_state()
        rng = np.random.default_rng(0)
        host = {"clips": rng.integers(0, 256, (2 * world, 8, 16, 16, 3),
                                      dtype=np.uint8),
                "labels": np.zeros(2 * world, np.float32)}
        _, metrics = tr.task.train_step(tr.state, tr.put_batch(host),
                                        seed=1)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"rank {rank}: loss {loss}")
        params = torch.cat([p.detach().reshape(-1)
                            for p in tr.state.params()])
        first = params.clone()
        dist.broadcast(first, src=0)
        if not torch.equal(params, first):
            raise RuntimeError(f"rank {rank}: parameters differ from rank "
                               "0's after the step")


def dryrun_multichip(n_devices: int) -> None:
    """One real data-parallel step of family D over `n_devices` gloo CPU
    processes (tiny shapes; nothing touches a card).  Raises where a rank
    fails."""
    run_world(_dryrun_rank, int(n_devices))
