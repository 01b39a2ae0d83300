"""End-to-end quickstart of the port: train -> evaluate -> export -> score
-> serve, on synthetic clips only (the counterpart of
`examples/quickstart.py`).

    python -m cvad_tpu_torch.quickstart [--epochs 2] [--out DIR] \\
        [--serve] [--device cpu]

Steps:
  1. family D's preset (``avenue_improved``) on a synthetic clip dataset;
  2. `Trainer.fit` for a few epochs;
  3. the last evaluation (the reference's metric dict);
  4. the trained scorer exported as one `torch.export` archive
     (``scorer.pt2`` under ``--out``);
  5. the archive loaded by `load_scorer`, which needs no model code, and a
     batch scored;
  6. with ``--serve``, the archive behind the HTTP endpoint, one batch
     POSTed and its scores checked against step 5's.

Everything runs on CUDA unless ``--device cpu``.  One JSON line a step.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import urllib.request
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="cvad_tpu_torch.quickstart")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--clips", type=int, default=64,
                    help="synthetic training clips")
    ap.add_argument("--out", default="cvad_quickstart")
    ap.add_argument("--serve", action="store_true",
                    help="also serve the archive over HTTP and POST a batch")
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # 1-2. family D on synthetic clips, trained
    from cvad_tpu_torch.config import preset
    from cvad_tpu_torch.train.engine import Trainer, make_loaders

    cfg = preset("avenue_improved")
    cfg = cfg.replace(
        data=cfg.data.replace(dataset="synthetic",
                              batch_size=args.batch_size),
        train=cfg.train.replace(num_epochs=args.epochs, out_dir=str(out),
                                eval_every=1))
    trainer = Trainer(cfg, device=args.device)
    history = trainer.fit(*make_loaders(cfg, n_synthetic=args.clips))
    print(json.dumps({"step": "train", "epochs": args.epochs,
                      "final_loss": history["train_losses"][-1]}))

    # 3. the last evaluation
    metrics = (history["evaluation_metrics"] or [{}])[-1]
    print(json.dumps({"step": "eval", **{k: float(v)
                                         for k, v in metrics.items()}}))

    # 4. the trained scorer as one torch.export archive
    from cvad_tpu_torch.evaluation.serving import export_scorer, load_scorer

    state = {k: v.detach() for k, v in
             trainer.state.model.state_dict().items()}
    blob = export_scorer(state, cfg=cfg.model, device=args.device)
    path = out / "scorer.pt2"
    path.write_bytes(blob)
    print(json.dumps({"step": "export", "out": str(path),
                      "bytes": len(blob)}))

    # 5. loaded with no model code, scored
    score = load_scorer(path.read_bytes())
    clips = np.random.default_rng(0).uniform(
        0, 1, (4,) + score.clip_shape).astype(np.float32)
    scores, graphs = score(clips)
    print(json.dumps({"step": "score", "scores": scores.tolist(),
                      "graphs": list(graphs.shape)}))

    # 6. optional: the archive behind the HTTP endpoint
    if args.serve:
        from cvad_tpu_torch.evaluation.http_service import (
            ScoringHTTPServer, service_from_path)

        srv = ScoringHTTPServer(service_from_path(str(path)), port=0)
        srv.start()
        try:
            buf = io.BytesIO()
            np.savez(buf, clips=clips)
            req = urllib.request.Request(
                f"http://{srv.host}:{srv.port}/score", data=buf.getvalue(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=300) as r:
                served = json.loads(r.read())["scores"]
        finally:
            srv.close()
        err = float(np.abs(np.asarray(served) - scores).max())
        print(json.dumps({"step": "serve", "scores": served,
                          "max_abs_err": err}))
        if err > 1e-5:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
