#!/usr/bin/env python3
"""Does a gloo process group of 2 ranks, both on ``cuda:0``, take the
port's collectives on CUDA tensors?

    python3 scripts/probe_gloo_cuda.py [--cpu]

Spawns 2 processes that start a gloo group from a ``file://`` rendezvous,
each with ``cuda:0`` as its device, and tries, on CUDA tensors: the
all-gather the port calls (``all_gather_single``, else
``all_gather_into_tensor``), ``all_reduce``, a sub-group from
``new_group``, and the port's own autograd collectives
(`parallel/collectives.py`: ``gather``, ``all_reduce_sum``,
``halo_exchange``, forward and backward) against their single-process
results.  Prints one JSON line a rank with each operation's outcome
("ok", or the error's type and message), the card's name and power limit
(nvidia-smi), and exits 0 only where every operation ran and agreed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _try(fn) -> str:
    try:
        return "ok" if fn() is not False else "mismatch"
    except Exception as e:  # the probe reports every failure, by type
        return f"{type(e).__name__}: {str(e)[:300]}"


def _rank(rank: int, world: int, init: str, out: str, device: str) -> None:
    import datetime

    import torch.distributed as dist

    from cvad_tpu_torch.parallel import collectives as col
    from cvad_tpu_torch.runtime.mesh import Axis

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    res = {"rank": rank}
    try:
        x = torch.arange(6, dtype=torch.float32, device=dev) + 10 * rank

        def gather_raw():
            out_t = torch.empty(12, device=dev)
            col._all_gather(out_t, x, None)
            want = torch.cat([torch.arange(6.0) + 10 * r
                              for r in range(world)]).to(dev)
            return torch.equal(out_t, want)

        def reduce_raw():
            y = x.clone()
            dist.all_reduce(y)
            want = sum(torch.arange(6.0) + 10 * r for r in range(world))
            return torch.equal(y, want.to(dev))

        res["all_gather"] = _try(gather_raw)
        res["all_reduce"] = _try(reduce_raw)
        group = None

        def sub_group():
            nonlocal group
            group = dist.new_group(list(range(world)))
            y = x.clone()
            dist.all_reduce(y, group=group)
            return bool(torch.isfinite(y).all())

        res["new_group"] = _try(sub_group)
        axis = Axis(world, rank, group or dist.group.WORLD)
        w = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(0))

        def autograd_ops():
            # each rank holds 2 of w's 4 rows, as a time rank its frames
            part = w[2 * rank:2 * rank + 2].to(dev).requires_grad_(True)
            g = col.gather(part, axis, dim=0)
            s = col.all_reduce_sum(part.sum(0, keepdim=True), axis)
            h = col.halo_exchange(part, axis, 1, 1, dim=0)
            loss = (g ** 2).sum() + (s ** 3).sum() + (h * h.flip(0)).sum()
            (gp,) = torch.autograd.grad(loss, part)
            ref = w.clone().requires_grad_(True)
            parts = [ref[2 * r:2 * r + 2] for r in range(world)]
            gr = torch.cat(parts)
            sr = sum(p.sum(0, keepdim=True) for p in parts)
            pad = torch.nn.functional.pad(ref, (0, 0, 0, 0, 1, 1))
            hs = [pad[2 * r:2 * r + 4] for r in range(world)]
            lr = world * ((gr ** 2).sum() + (sr ** 3).sum())
            lr = lr + sum((hh * hh.flip(0)).sum() for hh in hs)
            (gw,) = torch.autograd.grad(lr, ref)
            return bool(torch.allclose(gp.cpu(), gw[2 * rank:2 * rank + 2],
                                       rtol=1e-5, atol=1e-5))

        res["autograd_collectives"] = _try(autograd_ops)
    finally:
        dist.destroy_process_group()
    Path(out, f"{rank}.json").write_text(json.dumps(res))


def main() -> int:
    # --cpu rehearses the probe on CPU tensors (no card needed)
    device = "cpu" if "--cpu" in sys.argv[1:] else "cuda:0"
    if device != "cpu" and not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA card", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
           if device != "cpu" else "cpu")
    with tempfile.TemporaryDirectory(prefix="gloo_cuda_") as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        mp.start_processes(_rank, (2, init, tmp, device), nprocs=2,
                           start_method="spawn", join=True)
        ranks = [json.loads(Path(tmp, f"{r}.json").read_text())
                 for r in range(2)]
    for r in ranks:
        print(json.dumps(r))
    ok = all(v == "ok" for r in ranks for k, v in r.items() if k != "rank")
    print(json.dumps({"card": smi, "device": device,
                      "torch": torch.__version__, "all_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
