"""Command line of the port.

    python -m cvad_tpu_torch.cli train --preset avenue_improved \\
        --epochs 80 --out results [--n-synthetic 256] [--resume] \\
        [--set SEC.KEY=VAL ...] [--device cuda]
    python -m cvad_tpu_torch.cli train --preset memory_ae --out results_b
    python -m cvad_tpu_torch.cli serve CKPT.pth --port 8700 \\
        --buckets 1,8,32,128 --device cuda [--warmup] [--family b]

``train`` is `cvad_tpu/cli.py::cmd_train` for families D (presets
avenue_improved, family_d) and B (memory_ae, family_b) on synthetic clips:
it writes ``config.json``, the history, ``metrics.jsonl`` and the
checkpoints under ``--out``; ``--resume`` continues from the newest
checkpoint there (an intra-epoch 'mid' one included).  A trained
``checkpoints/best/model.pth`` is a reference-format ``.pth`` that ``serve``
reads.  ``serve`` is `cmd_serve`: the HTTP scoring endpoint of
`cvad_tpu_torch.evaluation.http_service` over a family-D or family-B
``.pth`` checkpoint (``--family``), with bucket-padded batching and
dynamic request coalescing.  Both run on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from cvad_tpu_torch.config import ExperimentConfig, preset


def _apply_overrides(cfg: ExperimentConfig, overrides) -> ExperimentConfig:
    """``SEC.KEY=VAL`` overrides, coerced to the field's current type;
    unknown sections or keys raise."""
    for item in overrides or []:
        key, _, raw = item.partition("=")
        section, _, field = key.partition(".")
        sub = getattr(cfg, section)
        cur = getattr(sub, field)
        cfg = cfg.replace(**{section: sub.replace(**{field: _coerce(raw,
                                                                   cur)})})
    return cfg


def _coerce(raw: str, like):
    if isinstance(like, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(like, int):
        return int(raw)
    if isinstance(like, float):
        return float(raw)
    if isinstance(like, tuple):
        parts = [p for p in raw.replace("(", "").replace(")", "").split(",")
                 if p]
        elem = like[0] if like else 0
        return tuple(type(elem)(p) for p in parts)
    return raw


def cmd_train(args) -> int:
    from cvad_tpu_torch.train.engine import Trainer, make_loaders

    cfg = preset(args.preset)
    if args.epochs is not None:
        cfg = cfg.replace(train=cfg.train.replace(num_epochs=args.epochs))
    if args.out:
        cfg = cfg.replace(train=cfg.train.replace(out_dir=args.out))
    cfg = _apply_overrides(cfg, args.set)

    out = Path(cfg.train.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(cfg.to_json())

    trainer = Trainer(cfg, device=args.device)
    train_loader, eval_loader = make_loaders(cfg, n_synthetic=args.n_synthetic)
    if args.resume:
        print(json.dumps({"resumed_from": trainer.restore()}))
    history = trainer.fit(train_loader, eval_loader)
    print(json.dumps({"final_loss": history["train_losses"][-1],
                      "epochs": len(history["epochs"]),
                      "best": str(trainer.ckpt.path("best")),
                      "device": str(trainer.device)}))
    return 0


def cmd_serve(args) -> int:
    from cvad_tpu_torch.evaluation.http_service import (ScoringHTTPServer,
                                                        service_from_path)

    svc = service_from_path(
        args.model, family=args.family,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        device=args.device)
    srv = ScoringHTTPServer(svc, host=args.host, port=args.port,
                            max_wait_ms=args.max_wait_ms)
    # an explicit --warmup-dtypes implies --warmup
    if args.warmup or args.warmup_dtypes != "float32":
        svc.warmup(dtypes=tuple(d.strip() for d in
                                args.warmup_dtypes.split(",") if d.strip()))
    print(json.dumps({"host": srv.host, "port": srv.port,
                      "buckets": list(svc.buckets), "device": args.device}),
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cvad_tpu_torch",
                                description="PyTorch/CUDA port of cvad_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train family D or B on synthetic "
                                     "clips")
    t.add_argument("--preset", default="avenue_improved",
                   help="avenue_improved|family_d (family D) or "
                        "memory_ae|family_b (family B)")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--out", default=None)
    t.add_argument("--n-synthetic", type=int, default=256)
    t.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in out_dir "
                        "(intra-epoch 'mid' checkpoints included)")
    t.add_argument("--set", action="append", metavar="SEC.KEY=VAL",
                   help="config override, e.g. --set optim.lr=1e-4")
    t.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    t.set_defaults(fn=cmd_train)

    sv = sub.add_parser("serve", help="HTTP scoring endpoint")
    sv.add_argument("model", help="reference-format .pth checkpoint")
    sv.add_argument("--family", default="d",
                    help="model family of the checkpoint: 'd' (default) or "
                         "'b'")
    sv.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8700,
                    help="0 binds an ephemeral port (printed at startup)")
    sv.add_argument("--buckets", default="1,8,32,128")
    sv.add_argument("--max-wait-ms", type=float, default=2.0,
                    dest="max_wait_ms")
    sv.add_argument("--warmup", action="store_true",
                    help="run every bucket before accepting traffic")
    sv.add_argument("--warmup-dtypes", default="float32",
                    dest="warmup_dtypes",
                    help="comma list of client payload dtypes to warm up "
                         "(e.g. float32,uint8)")
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
