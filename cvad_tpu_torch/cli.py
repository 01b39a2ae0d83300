"""Command line of the port.

    python -m cvad_tpu_torch.cli train --preset avenue_improved \\
        --epochs 80 --out results [--n-synthetic 256] [--resume] \\
        [--profile-dir TRACE_DIR] \\
        [--dataset ucsd_ped2 --data-root TREE] [--set SEC.KEY=VAL ...] \\
        [--device cuda]
    python -m cvad_tpu_torch.cli train --preset memory_ae --out results_b
    python -m cvad_tpu_torch.cli train --preset mini3d --out results_c
    python -m cvad_tpu_torch.cli train --preset causal_pipeline --out results_a
    python -m cvad_tpu_torch.cli serve CKPT.pth --port 8700 \\
        --buckets 1,8,32,128 --device cuda [--warmup] [--family b]
    python -m cvad_tpu_torch.cli synth --out TREE --videos 2 --frames 24 \\
        [--write-gt] [--format pgm]
    python -m cvad_tpu_torch.cli score TREE/Test [--checkpoint CKPT.pth]
    python -m cvad_tpu_torch.cli auc --data-root TREE \\
        (--torch-checkpoint CKPT.pth [--family d|b|c|a] | --out RUN \
        [--step best])
    python -m cvad_tpu_torch.cli eval --out RUN [--step latest] \\
        [--dataset ucsd_ped2 --data-root TREE]

``train`` is `cvad_tpu/cli.py::cmd_train` for families D (presets
avenue_improved, family_d), B (memory_ae, family_b), C (mini3d, family_c)
and A (causal_pipeline, family_a; the anchor variant causal_pipeline_v0,
family_a_anchor), on synthetic clips
or, with ``--dataset`` and ``--data-root``, on a frame-folder tree: it
writes ``config.json``, the history, ``metrics.jsonl`` and the checkpoints
under ``--out``; ``--resume`` continues from the newest checkpoint there
(an intra-epoch 'mid' one included); ``--profile-dir`` writes a
`torch.profiler` trace of one unrecorded epoch 0 before the run.  A trained
``checkpoints/best/model.pth`` is a reference-format ``.pth`` that ``serve``
reads.  ``serve`` is `cmd_serve`: the HTTP scoring endpoint of
`cvad_tpu_torch.evaluation.http_service` over a family-D or family-B
``.pth`` checkpoint (``--family``), with bucket-padded batching and
dynamic request coalescing.  ``synth`` writes a UCSD-style frame-folder
tree (`cmd_synth`); ``score`` scores every sliding window of every video
under a folder with a family-D ``.pth`` and keeps the windows above the
threshold (`cmd_score`); ``auc`` is the frame-level ROC-AUC against the
tree's ground truth (`cmd_auc`) from a ``.pth`` of family D, B, C or A
(the model config of ``--preset`` where it is that family's, else the
family's default) or from a training run's checkpoint of any ported
family; ``eval`` evaluates a training run's checkpoint on the test split
(`cmd_eval`).  Everything runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from cvad_tpu_torch.config import (FAMILY_CONFIGS, DataConfig,
                                   ExperimentConfig, preset)

# the family-D checkpoint the repository ships (the reference's .pth format)
FIXTURE = (Path(__file__).resolve().parent.parent / "runs" / "dyn_parity_d"
           / "ours" / "best_improved_model.pth")


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


def _with_data(cfg: ExperimentConfig, args) -> ExperimentConfig:
    """``--data-root``, ``--dataset`` and ``--out`` into the config."""
    if args.data_root:
        cfg = cfg.replace(data=cfg.data.replace(
            root=args.data_root, dataset=args.dataset or cfg.data.dataset))
    elif args.dataset:
        cfg = cfg.replace(data=cfg.data.replace(dataset=args.dataset))
    if args.out:
        cfg = cfg.replace(train=cfg.train.replace(out_dir=args.out))
    return cfg


def cmd_train(args) -> int:
    from cvad_tpu_torch.train.engine import Trainer, make_loaders

    cfg = preset(args.preset)
    if args.epochs is not None:
        cfg = cfg.replace(train=cfg.train.replace(num_epochs=args.epochs))
    cfg = _with_data(cfg, args)
    cfg = _apply_overrides(cfg, args.set)

    out = Path(cfg.train.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(cfg.to_json())

    trainer = Trainer(cfg, device=args.device)
    train_loader, eval_loader = make_loaders(cfg, n_synthetic=args.n_synthetic)
    if args.resume:
        print(json.dumps({"resumed_from": trainer.restore()}))
    if args.profile_dir:
        # one unrecorded epoch 0 under the profiler before the run, as
        # cvad_tpu's train does (it trains the state it profiles)
        from cvad_tpu_torch.runtime.metrics import profile_trace

        if trainer.state is None:  # --resume keeps the restored state
            trainer.init_state()
        with profile_trace(args.profile_dir, trainer.device):
            trainer.train_epoch(train_loader, epoch=0, record=False)
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


def cmd_eval(args) -> int:
    """Evaluate a training run's checkpoint ('latest', 'best', 'mid' or an
    epoch number) on the test split; writes ``eval_metrics.json`` under
    the run's directory."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.train.engine import Trainer
    from cvad_tpu_torch.utils.json_utils import safe_json_save

    cfg = _apply_overrides(_with_data(preset(args.preset), args), args.set)
    trainer = Trainer(cfg, device=args.device)
    loader = BatchLoader(
        build_dataset(cfg.data, "Test", max(args.n_synthetic // 2, 2)),
        cfg.data.batch_size, shuffle=False,
        num_threads=cfg.data.num_decode_threads, prefetch=cfg.data.prefetch,
        transfer_dtype=cfg.data.transfer_dtype)
    step = int(args.step) if str(args.step).isdigit() else args.step
    try:
        restored = trainer.restore(step)
    except FileNotFoundError as e:  # an explicit --step not on disk
        restored, detail = None, str(e)
    else:
        detail = None
    if restored is None:
        print(json.dumps({"error": "no checkpoint found", "step": str(step),
                          "out_dir": cfg.train.out_dir,
                          **({"detail": detail[-300:]} if detail else {})}))
        return 1
    metrics = trainer.evaluate(loader)
    scalar = {k: float(v) for k, v in metrics.items()
              if isinstance(v, (int, float)) and np.isfinite(v)}
    safe_json_save({**scalar, "checkpoint": str(step), "epoch": restored},
                   Path(cfg.train.out_dir) / "eval_metrics.json",
                   verbose=False)
    print(json.dumps({"checkpoint": str(step), "epoch": restored, **scalar}))
    return 0


def cmd_score(args) -> int:
    """Score every sliding window of every video under ``video_root`` with
    a family-D ``.pth`` and write the windows above ``--threshold``
    (``anomalous_clips.json`` under ``--out``)."""
    from cvad_tpu_torch.evaluation.scoring import (VideoScorer,
                                                   make_family_d_score_fn)
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.utils.json_utils import safe_json_save

    cfg = DataConfig(clip_len=args.clip_len, stride=args.stride,
                     frame_size=(args.frame_size, args.frame_size), channels=3)
    scorer = VideoScorer(make_family_d_score_fn(
        load_torch_state_dict(args.checkpoint), device=args.device), cfg)
    clips = scorer.extract_anomalous_clips(args.video_root,
                                           threshold=args.threshold,
                                           max_clips=args.max_clips)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    safe_json_save([dataclasses.asdict(c) | {"causal_graph": None}
                    for c in clips], out / "anomalous_clips.json",
                   verbose=False)
    print(json.dumps({"anomalous_clips": len(clips),
                      "max_score": max((c.score for c in clips),
                                       default=0.0)}))
    return 0


def cmd_auc(args) -> int:
    """Frame-level ROC-AUC against the tree's ground truth (UCSD ``_gt``
    masks, Avenue ``.mat`` volumes, ``.npy`` vectors), scored from a
    reference-format ``.pth`` (``--torch-checkpoint``, families d and b) or
    from a training run's checkpoint (``--out`` and ``--step``)."""
    from cvad_tpu_torch.evaluation.frame_auc import (dataset_frame_auc,
                                                     make_trainer_score_fn)
    from cvad_tpu_torch.utils.json_utils import safe_json_save

    cfg = preset(args.preset)
    if args.data_root:
        cfg = cfg.replace(data=cfg.data.replace(root=args.data_root))
    if args.out:
        cfg = cfg.replace(train=cfg.train.replace(out_dir=args.out))
    cfg = _apply_overrides(cfg, args.set)
    if args.torch_checkpoint:
        from cvad_tpu_torch.evaluation.scoring import make_score_fn
        from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

        score_fn = make_score_fn(args.family,
                                 load_torch_state_dict(args.torch_checkpoint),
                                 cfg=_family_model(cfg, args.family),
                                 device=args.device)
    else:
        from cvad_tpu_torch.train.engine import Trainer

        trainer = Trainer(cfg, device=args.device)
        step = int(args.step) if str(args.step).isdigit() else args.step
        restored = _try_restore(trainer, step)
        if restored is None and step == "best":
            restored = _try_restore(trainer, "latest")
        if restored is None:
            print(json.dumps({"error": "no checkpoint found",
                              "step": str(step),
                              "out_dir": cfg.train.out_dir}))
            return 1
        score_fn = make_trainer_score_fn(trainer)
    report = dataset_frame_auc(score_fn, cfg.data, cfg.data.root,
                               split=args.split, batch_size=args.batch_size)
    if args.report_out:
        safe_json_save(report, args.report_out, verbose=False)
    print(json.dumps({k: report.get(k) for k in
                      ("frame_auc", "frame_auc_normalized", "macro_auc",
                       "n_videos", "n_frames", "anomalous_frames")}))
    return 0 if report.get("frame_auc") is not None else 1


def _family_model(cfg: ExperimentConfig, family: str):
    """The preset's model config where the preset is of `family`, else None
    (the family's default)."""
    return (cfg.model if type(cfg.model) is FAMILY_CONFIGS.get(family)
            else None)


def _try_restore(trainer, step):
    try:
        return trainer.restore(step)
    except FileNotFoundError:
        return None


def cmd_synth(args) -> int:
    """Write a synthetic UCSD-style frame-folder tree (Train and Test
    splits, a folder of frames a video, ``_gt`` mask folders with
    ``--write-gt``), byte for byte what `cvad_tpu`'s ``synth`` writes."""
    from cvad_tpu_torch.data.synthetic import write_synthetic_video_tree

    root = write_synthetic_video_tree(
        args.out, videos_per_split=args.videos,
        frames_per_video=args.frames,
        hw=tuple(int(x) for x in args.hw.split(",")),
        channels=args.channels, fmt=args.format, seed=args.seed,
        write_gt=args.write_gt)
    n = sum(1 for f in Path(root).rglob("*") if f.is_file())
    print(json.dumps({"root": root, "files": n, "format": args.format}))
    return 0


def _device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cvad_tpu_torch",
                                description="PyTorch/CUDA port of cvad_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train family D, B, C or A on "
                                     "synthetic clips or a frame-folder tree")
    t.add_argument("--preset", default="avenue_improved",
                   help="avenue_improved|family_d (family D), "
                        "memory_ae|family_b (family B), mini3d|family_c "
                        "(family C), causal_pipeline|family_a or "
                        "causal_pipeline_v0|family_a_anchor (family A)")
    t.add_argument("--dataset", default=None,
                   help="synthetic|ucsd_ped2|ucsd_ped2_simple|avenue")
    t.add_argument("--data-root", default=None)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--out", default=None)
    t.add_argument("--n-synthetic", type=int, default=256)
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of one "
                        "unrecorded epoch before the run")
    t.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in out_dir "
                        "(intra-epoch 'mid' checkpoints included)")
    t.add_argument("--set", action="append", metavar="SEC.KEY=VAL",
                   help="config override, e.g. --set optim.lr=1e-4")
    _device_arg(t)
    t.set_defaults(fn=cmd_train)

    ev = sub.add_parser("eval", help="evaluate a training run's checkpoint")
    ev.add_argument("--preset", default="avenue_improved")
    ev.add_argument("--dataset", default=None)
    ev.add_argument("--data-root", default=None)
    ev.add_argument("--out", default=None,
                    help="training out_dir holding the checkpoints")
    ev.add_argument("--step", default="latest",
                    help="latest|best|mid|<epoch number>")
    ev.add_argument("--n-synthetic", type=int, default=64)
    ev.add_argument("--set", action="append", metavar="SEC.KEY=VAL")
    _device_arg(ev)
    ev.set_defaults(fn=cmd_eval)

    sc = sub.add_parser("score", help="score every window of every video "
                                      "under a folder (family D)")
    sc.add_argument("video_root")
    sc.add_argument("--checkpoint", default=str(FIXTURE))
    sc.add_argument("--threshold", type=float, default=0.3)
    sc.add_argument("--clip-len", type=int, default=8)
    sc.add_argument("--stride", type=int, default=4)
    sc.add_argument("--frame-size", type=int, default=64)
    sc.add_argument("--max-clips", type=int, default=10)
    sc.add_argument("--out", default="anomaly_output")
    _device_arg(sc)
    sc.set_defaults(fn=cmd_score)

    au = sub.add_parser("auc", help="frame-level ROC-AUC against the "
                                    "tree's ground truth")
    au.add_argument("--preset", default="avenue_improved")
    au.add_argument("--data-root", required=True,
                    help="dataset root holding the split and ground truth")
    au.add_argument("--split", default="Test")
    au.add_argument("--torch-checkpoint", default=None,
                    help="score from a reference-format .pth")
    au.add_argument("--family", default="d", choices=list("abcde"),
                    help="model family of --torch-checkpoint (d, b, c and "
                         "a are ported)")
    au.add_argument("--out", default=None,
                    help="training out_dir holding the checkpoints")
    au.add_argument("--step", default="best",
                    help="best|latest|mid|<epoch> (with --out); 'best' "
                         "falls back to 'latest' if no best was saved")
    au.add_argument("--batch-size", type=int, default=64)
    au.add_argument("--report-out", default=None,
                    help="write the full per-video report JSON here")
    au.add_argument("--set", action="append", metavar="SEC.KEY=VAL")
    _device_arg(au)
    au.set_defaults(fn=cmd_auc)

    sy = sub.add_parser("synth", help="write a synthetic dataset tree")
    sy.add_argument("--out", default="synthetic_ucsd")
    sy.add_argument("--format", default="pgm",
                    choices=("pgm", "ppm", "npy", "tif", "tif_lzw", "jpg",
                             "png"))
    sy.add_argument("--videos", type=int, default=2)
    sy.add_argument("--frames", type=int, default=24)
    sy.add_argument("--hw", default="64,64")
    sy.add_argument("--channels", type=int, default=1)
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--write-gt", action="store_true",
                    help="write UCSD-style <video>_gt mask folders with "
                         "frame-level anomaly segments")
    sy.set_defaults(fn=cmd_synth)

    sv = sub.add_parser("serve", help="HTTP scoring endpoint")
    sv.add_argument("model", help="reference-format .pth checkpoint")
    sv.add_argument("--family", default="d",
                    help="model family of the checkpoint: 'd' (default) or "
                         "'b'")
    _device_arg(sv)
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
