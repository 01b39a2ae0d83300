"""Command line of the port.

    python -m cvad_tpu_torch.cli train --preset avenue_improved \\
        --epochs 80 --out results [--n-synthetic 256] [--resume] \\
        [--profile-dir TRACE_DIR] \\
        [--dataset ucsd_ped2 --data-root TREE] [--set SEC.KEY=VAL ...] \\
        [--device cuda]
    torchrun --nproc_per_node=N -m cvad_tpu_torch.cli train \\
        [--set parallel.temporal_axis=T] [--device cpu] ...
    python -m cvad_tpu_torch.cli train --preset memory_ae --out results_b
    python -m cvad_tpu_torch.cli train --preset mini3d --out results_c
    python -m cvad_tpu_torch.cli train --preset causal_pipeline --out results_a
    python -m cvad_tpu_torch.cli serve CKPT.pth --port 8700 \\
        --buckets 1,8,32,128 --device cuda [--warmup] [--family b] \\
        [--probe-timeout 120]
    python -m cvad_tpu_torch.cli export CKPT.pth --family a|b|c|d|e \\
        --out scorer.pt2 [--clip-len 128] [--preset P --set SEC.KEY=VAL] \\
        [--device cuda]
    python -m cvad_tpu_torch.cli serve scorer.pt2 --port 8700
    python -m cvad_tpu_torch.cli convert CKPT.pth --family a|b|c|d|e \
        --out RUN [--preset P --set SEC.KEY=VAL]
    python -m cvad_tpu_torch.cli synth --out TREE --videos 2 --frames 24 \\
        [--write-gt] [--format pgm]
    python -m cvad_tpu_torch.cli score TREE/Test [--checkpoint CKPT.pth]
    python -m cvad_tpu_torch.cli report TREE/Test [--checkpoint CKPT.pth] \\
        [--threshold 0.3] [--max-clips 10] [--detector auto] [--out DIR]
    python -m cvad_tpu_torch.cli auc --data-root TREE \\
        (--torch-checkpoint CKPT.pth [--family d|b|c|a|e] | --out RUN \
        [--step best])
    python -m cvad_tpu_torch.cli eval --out RUN [--step latest] \\
        [--dataset ucsd_ped2 --data-root TREE]
    python -m cvad_tpu_torch.cli plots HISTORY.json [--out PNG]
    python -m cvad_tpu_torch.cli plots --block-correlation [--run RUN \\
        --step latest] [--preset family_c] [--out PNG]
    python -m cvad_tpu_torch.cli diagnose HISTORY.json
    python -m cvad_tpu_torch.cli smoke [--data-root TREE]
    python -m cvad_tpu_torch.cli doctor [--probe-timeout 60]

``train`` is `cvad_tpu/cli.py::cmd_train` (under ``torchrun`` on the
ranks of a mesh, ``--set parallel.data_axis=D --set
parallel.temporal_axis=T``: every trained family shards its clips' T
over a time axis where ``data.clip_len`` splits over it) for families D
(presets
avenue_improved, family_d), B (memory_ae, family_b), C (mini3d, family_c)
and A (causal_pipeline, family_a; the anchor variant causal_pipeline_v0,
family_a_anchor), on synthetic clips
or, with ``--dataset`` and ``--data-root``, on a frame-folder tree: it
writes ``config.json``, the history, ``metrics.jsonl`` and the checkpoints
under ``--out``; ``--resume`` continues from the newest checkpoint there
(an intra-epoch 'mid' one included); ``--profile-dir`` writes a
`torch.profiler` trace of one unrecorded epoch 0 before the run.  Family E
(bbox_viz) scores only, as in `cvad_tpu`.  A trained
``checkpoints/best/model.pth`` is a reference-format ``.pth`` that ``serve``
reads.  ``serve`` is `cmd_serve`: the HTTP scoring endpoint of
`cvad_tpu_torch.evaluation.http_service` over a family-D or family-B
``.pth`` checkpoint (``--family``) or an exported scorer of any family,
with bucket-padded batching and dynamic request coalescing, after a device
check (``--probe-timeout``).  ``export`` writes a family's scorer as a
`torch.export` archive (`cmd_export`).  ``convert`` writes a
reference-format ``.pth`` as a training checkpoint that ``eval --out``,
``auc --out`` and ``train --resume`` read (`cmd_convert`).
``synth`` writes a UCSD-style frame-folder
tree (`cmd_synth`); ``score`` scores every sliding window of every video
under a folder with a family-D ``.pth`` and keeps the windows above the
threshold (`cmd_score`); ``report`` does the same, then localizes people
in each kept clip (``--detector``: auto, motion, yolov5 or opencv; the
last two need local weights), draws score-tiered boxes and writes the
per-clip and aggregate JSON and HTML reports (`cmd_report`; PNG grids and
heatmaps where matplotlib is present, MP4s where cv2 is); ``auc`` is the
frame-level ROC-AUC against the tree's ground truth (`cmd_auc`) from a
``.pth`` of family D, B, C, A or E (the model config of ``--preset``
where it is that family's, else the family's default) or from a training
run's checkpoint of any trained family; ``eval`` evaluates a training
run's checkpoint on the test split (`cmd_eval`).  ``plots`` draws a
history's dashboard, or with ``--block-correlation`` family C's per-block
channel correlations from a run's checkpoint or a fresh init;
``diagnose`` reads a history for warnings; ``smoke`` is the pre-training
gate (family C's forward on the device, and a dataset's dtypes);
``doctor`` reports the native decoder, the optional modules and the CUDA
devices (asked in a child process) and exits 1 when no card answers.
Everything runs on CUDA unless ``--device cpu``.
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
    """Under ``torchrun --nproc_per_node=N -m cvad_tpu_torch.cli train``
    every process joins the process group (`multihost.initialize`: NCCL
    on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and trains its
    part of the mesh that ``--set parallel.*`` lays out; rank 0 alone
    writes the run directory and prints the summary."""
    import torch.distributed as dist

    from cvad_tpu_torch.runtime import multihost

    started = not dist.is_initialized()
    info = multihost.initialize(device=args.device)
    started = started and dist.is_initialized()
    try:
        return _train(args, info.is_primary)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, primary: bool) -> int:
    from cvad_tpu_torch.train.engine import Trainer, make_loaders

    cfg = preset(args.preset)
    if args.epochs is not None:
        cfg = cfg.replace(train=cfg.train.replace(num_epochs=args.epochs))
    cfg = _with_data(cfg, args)
    cfg = _apply_overrides(cfg, args.set)

    out = Path(cfg.train.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if primary:
        (out / "config.json").write_text(cfg.to_json())

    trainer = Trainer(cfg, device=args.device)
    train_loader, eval_loader = make_loaders(cfg, n_synthetic=args.n_synthetic)
    if args.resume:
        resumed = trainer.restore()
        if primary:
            print(json.dumps({"resumed_from": resumed}))
    if args.profile_dir:
        # one unrecorded epoch 0 under the profiler before the run, as
        # cvad_tpu's train does (it trains the state it profiles)
        from cvad_tpu_torch.runtime.metrics import profile_trace

        if trainer.state is None:  # --resume keeps the restored state
            trainer.init_state()
        with profile_trace(args.profile_dir, trainer.device):
            trainer.train_epoch(train_loader, epoch=0, record=False)
    history = trainer.fit(train_loader, eval_loader)
    if primary:
        print(json.dumps({"final_loss": history["train_losses"][-1],
                          "epochs": len(history["epochs"]),
                          "best": str(trainer.ckpt.path("best")),
                          "device": str(trainer.device),
                          "mesh": trainer.mesh.shape}))
    return 0


def cmd_export(args) -> int:
    """A family's scorer from a reference-format ``.pth`` as one
    `torch.export` archive that ``load_scorer``, ``serve`` and
    `ClipScoringService.from_exported` run with no model code.  The model
    config is ``--preset``'s (the family's own preset by default) with the
    ``--set`` overrides; the clip shape is its data config's, T from
    ``--clip-len`` where given (family A's channels from the checkpoint's
    conv1).  The artefact runs on ``--device``, where it was traced."""
    from cvad_tpu_torch.evaluation import serving
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    cfg = _apply_overrides(preset(args.preset or f"family_{args.family}"),
                           args.set)
    model_cfg = _family_model(cfg, args.family)
    if model_cfg is None:
        print(json.dumps({"error": f"preset {args.preset!r} is not of "
                                   f"family {args.family!r}"}))
        return 1
    state = load_torch_state_dict(args.torch_checkpoint)
    channels = (state["backbone.conv1.weight"].shape[1]
                if args.family == "a" else cfg.data.channels)
    clip = (args.clip_len or cfg.data.clip_len, *cfg.data.frame_size,
            channels)
    blob = serving.EXPORTERS[args.family](state, clip_shape=clip,
                                          cfg=model_cfg, device=args.device)
    Path(args.out).write_bytes(blob)
    print(json.dumps({"out": args.out, "bytes": len(blob)}))
    return 0


def cmd_convert(args) -> int:
    """`cvad_tpu/cli.py::cmd_convert` for the port: the ``.pth``
    (`load_torch_state_dict`: any of the reference's formats) loaded into
    ``--family``'s model (``--preset``'s config, the family's own preset
    by default, with the ``--set`` overrides; family A's channels from
    the checkpoint's conv1) with ``strict=True``, so that a checkpoint of
    another family or width exits 1 with a JSON error, then written by
    the port's `CheckpointManager` under ``--out``'s ``checkpoints``, as
    a training run keeps them: a whole train state at step 0, the weights
    beside a fresh optimizer (zero moments and count, the config's lr),
    which ``eval --out``, ``auc --out`` and ``train --resume`` find as the
    latest checkpoint, so a resumed run starts there.  Prints ``{"params":
    n, "out": ...}``, n the model's parameter count
    (``model.parameters()``): that of
    `cvad_tpu`'s imported ``params`` tree, but family A's, which is 128
    above it (the GRU's r and z hidden biases, held at 0, which the port
    keeps as ``nn.GRU`` does).  `cvad_tpu`'s ``convert`` counts every
    leaf of its variables, the BatchNorm statistics and family B's bank
    with the parameters."""
    from cvad_tpu_torch.models.registry import build_model
    from cvad_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                   load_torch_state_dict)
    from cvad_tpu_torch.train.optim import build_optimizer, flatten
    from cvad_tpu_torch.train.state import TrainState, trainable

    cfg = _apply_overrides(preset(args.preset or f"family_{args.family}"),
                           args.set)
    model_cfg = _family_model(cfg, args.family)
    if model_cfg is None:
        print(json.dumps({"error": f"preset {args.preset!r} is not of "
                                   f"family {args.family!r}"}))
        return 1
    state = load_torch_state_dict(args.torch_checkpoint)
    kw = {}
    if args.family == "a" and "backbone.conv1.weight" in state:
        kw["in_channels"] = state["backbone.conv1.weight"].shape[1]
    model = build_model(model_cfg, **kw)
    try:
        model.load_state_dict(state, strict=True)
    except RuntimeError as e:
        print(json.dumps({"error": f"{args.torch_checkpoint} is not a "
                                   f"family-{args.family.upper()} checkpoint "
                                   "of this config",
                          "detail": str(e)[:500]}))
        return 1
    fresh = build_optimizer(cfg.optim).init(
        flatten(trainable(model)).detach())
    path = CheckpointManager(str(Path(args.out) / "checkpoints")).save(
        0, TrainState(model, fresh))
    n = sum(p.numel() for p in model.parameters())
    print(json.dumps({"params": n, "out": str(path)}))
    return 0


def _serving_device(args):
    """The device `serve` runs on, ``--device``, checked before the device
    probe and any model load: the file must be servable
    (`http_service.servable_kind`: not empty or unreadable, no ``.pth`` of
    family A, C or E), an exported scorer must have been exported for that
    device (each a `ValueError`); CUDA asked for on a host without it
    raises `resolve_device`'s `RuntimeError`, as every entry point does."""
    from cvad_tpu_torch.evaluation.http_service import servable_kind
    from cvad_tpu_torch.evaluation.serving import artefact_meta
    from cvad_tpu_torch.runtime.device import resolve_device

    kind = servable_kind(args.model, args.family)
    device = resolve_device(args.device)
    if kind == "artefact":
        runs_on = artefact_meta(Path(args.model).read_bytes())["device"]
        if runs_on != device.type:
            raise ValueError(f"{args.model} was exported for {runs_on}, not "
                             f"{device.type}: serve it with --device "
                             f"{runs_on}, or export it on {device.type}")
    return device


def cmd_serve(args) -> int:
    """The HTTP scoring endpoint over a family-D or family-B ``.pth``
    (``--family``) or an exported scorer of any family, on ``--device``
    (CUDA by default).  A file that cannot be served there exits 1 with a
    JSON error (`_serving_device`).  Serving on CUDA, the device check of
    `cvad_tpu`'s ``serve`` runs next (a child process with
    ``--probe-timeout`` seconds; 0 skips it): a card that does not answer
    exits 1 with a JSON error before any model loads."""
    from cvad_tpu_torch.evaluation.http_service import (ScoringHTTPServer,
                                                        service_from_path)

    try:
        device = _serving_device(args)
    except ValueError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    if args.probe_timeout > 0 and device.type == "cuda":
        from cvad_tpu_torch.runtime.doctor import probe_devices

        status, detail = probe_devices(args.probe_timeout)
        if status != "ok":
            print(json.dumps({"error": "accelerator unreachable",
                              "device_probe": status, "detail": detail}))
            return 1
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
                      "buckets": list(svc.buckets), "device": str(device)}),
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


def cmd_report(args) -> int:
    """`cmd_score`'s windows above ``--threshold``, localized and
    annotated, with the per-clip and aggregate JSON and HTML reports under
    ``--out`` (`evaluation/bbox.py`)."""
    from cvad_tpu_torch.evaluation.bbox import AnomalyVisualizer
    from cvad_tpu_torch.evaluation.scoring import (VideoScorer,
                                                   make_family_d_score_fn)
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    cfg = DataConfig(clip_len=args.clip_len, stride=args.stride,
                     frame_size=(args.frame_size, args.frame_size), channels=3)
    scorer = VideoScorer(make_family_d_score_fn(
        load_torch_state_dict(args.checkpoint), device=args.device), cfg)
    clips = scorer.extract_anomalous_clips(args.video_root,
                                           threshold=args.threshold,
                                           max_clips=args.max_clips)
    viz = AnomalyVisualizer(scorer, detector_backend=args.detector)
    summary = viz.create_report(clips, args.out)
    print(json.dumps({"clips": summary["total_clips_analyzed"],
                      "report": str(Path(args.out)
                                    / "anomaly_detection_report.html")}))
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


def cmd_diagnose(args) -> int:
    from cvad_tpu_torch.utils.diagnose import diagnose_training_issues

    result = diagnose_training_issues(history_file=args.history)
    print(json.dumps(result["warnings"]))
    return 0


def cmd_smoke(args) -> int:
    """Pre-training gate (``minicausal_vad_complete3.py:503-561``): family
    C's forward on the device, and with ``--data-root`` the dtypes of a
    few of the dataset's samples."""
    from cvad_tpu_torch.utils.diagnose import (debug_dataset_dtypes,
                                               smoke_test_model)

    result = smoke_test_model(verbose=False, device=args.device)
    if args.data_root:
        from cvad_tpu_torch.data.datasets import build_dataset

        cfg = DataConfig(dataset=args.dataset, root=args.data_root)
        recs = debug_dataset_dtypes(build_dataset(cfg), verbose=False)
        result["dataset_samples"] = recs
        result["ok"] = result["ok"] and not any(
            r.get("float64") or "error" in r for r in recs)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


def cmd_plots(args) -> int:
    if args.block_correlation:
        return _cmd_block_correlation(args)
    from cvad_tpu_torch.evaluation.plots import visualize_training_results
    from cvad_tpu_torch.utils.json_utils import safe_json_load

    if not args.history:
        print("plots needs a history JSON (or --block-correlation)",
              file=sys.stderr)
        return 1
    history = safe_json_load(args.history)
    if history is None:
        print(f"cannot read history: {args.history}", file=sys.stderr)
        return 1
    path = visualize_training_results(history, args.out)
    print(path or "matplotlib unavailable")
    return 0 if path else 1


def _cmd_block_correlation(args) -> int:
    """Per-block channel-correlation heatmaps of family C (the analysis
    behind the reference's ``Figure 2025-09-04 180626.png``) from a run's
    checkpoint (``--run``, ``--step``) or a fresh init, on the first batch
    of the test split."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.evaluation.block_correlation import (
        block_channel_correlations, plot_block_correlations)
    from cvad_tpu_torch.train.engine import Trainer
    from cvad_tpu_torch.train.tasks import build_task

    cfg = preset(args.preset)
    if args.data_root:
        cfg = cfg.replace(data=cfg.data.replace(root=args.data_root))
    if args.run:
        cfg = cfg.replace(train=cfg.train.replace(out_dir=args.run))
    cfg = _apply_overrides(cfg, args.set)
    sample = BatchLoader(build_dataset(cfg.data, "Test", 32),
                         cfg.data.batch_size, shuffle=False).sample_batch()
    restored = None
    if args.run:
        trainer = Trainer(cfg, device=args.device)
        step = int(args.step) if str(args.step).isdigit() else args.step
        restored = _try_restore(trainer, step)
        if restored is None:
            print(json.dumps({"error": "no checkpoint found",
                              "out_dir": cfg.train.out_dir}))
            return 1
        state = trainer.state
    else:  # fresh init: a structure-only figure
        from cvad_tpu_torch.runtime.device import resolve_device

        state = build_task(cfg).init_state(cfg.train.seed,
                                           resolve_device(args.device))
    mats = block_channel_correlations(state.model.state_dict(),
                                      sample["clips"], cfg.model,
                                      device=args.device)
    path = plot_block_correlations(mats, args.out)
    print(json.dumps({
        "out": path, "restored": restored,
        "blocks": [m.shape[0] for m in mats],
        "mean_abs_offdiag": [round(float(
            (np.abs(m).sum() - m.shape[0]) / (m.size - m.shape[0])), 4)
            for m in mats]}))
    return 0 if path else 1


def cmd_doctor(args) -> int:
    """Environment report: the native decoder and its formats, the
    optional modules, nvcc, and the CUDA devices (asked in a child process
    with a hard timeout).  One JSON object; exit 1 when no card answers."""
    import importlib.util

    from cvad_tpu_torch.data.native_decoder import (load_library,
                                                    supported_suffixes)
    from cvad_tpu_torch.ops._build import _nvcc
    from cvad_tpu_torch.runtime.doctor import probe_devices

    info: dict = {"native_decoder": load_library() is not None,
                  "native_formats": sorted(supported_suffixes())}
    for mod in ("PIL", "cv2", "matplotlib", "sklearn", "scipy"):
        info[f"has_{mod.lower()}"] = importlib.util.find_spec(mod) is not None
    try:
        info["nvcc"] = _nvcc()
    except RuntimeError:
        info["nvcc"] = None
    status, detail = probe_devices(args.probe_timeout)
    info["device_probe"] = status
    info["devices" if status == "ok" else "device_probe_detail"] = detail
    print(json.dumps(info))
    return 0 if status == "ok" else 1


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

    for name, fn, what in (
            ("score", cmd_score, "score every window of every video under a "
                                 "folder (family D)"),
            ("report", cmd_report, "score, localize and annotate the "
                                   "anomalous windows; JSON and HTML "
                                   "reports (family D)")):
        sc = sub.add_parser(name, help=what)
        sc.add_argument("video_root")
        sc.add_argument("--checkpoint", default=str(FIXTURE))
        sc.add_argument("--threshold", type=float, default=0.3)
        sc.add_argument("--clip-len", type=int, default=8)
        sc.add_argument("--stride", type=int, default=4)
        sc.add_argument("--frame-size", type=int, default=64)
        sc.add_argument("--max-clips", type=int, default=10)
        sc.add_argument("--out", default="anomaly_output")
        if name == "report":
            sc.add_argument("--detector", default="auto",
                            help="auto|motion|yolov5|opencv (auto: the "
                                 "ladder, motion without local weights)")
        _device_arg(sc)
        sc.set_defaults(fn=fn)

    au = sub.add_parser("auc", help="frame-level ROC-AUC against the "
                                    "tree's ground truth")
    au.add_argument("--preset", default="avenue_improved")
    au.add_argument("--data-root", required=True,
                    help="dataset root holding the split and ground truth")
    au.add_argument("--split", default="Test")
    au.add_argument("--torch-checkpoint", default=None,
                    help="score from a reference-format .pth")
    au.add_argument("--family", default="d", choices=list("abcde"),
                    help="model family of --torch-checkpoint")
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

    x = sub.add_parser("export", help="a family's scorer as one "
                                      "torch.export archive")
    x.add_argument("torch_checkpoint")
    x.add_argument("--family", default="d", choices=list("abcde"),
                   help="which family the .pth belongs to")
    x.add_argument("--out", default="scorer.pt2")
    x.add_argument("--preset", default=None,
                   help="the model config's preset (default: family_<f>)")
    x.add_argument("--clip-len", type=int, default=None, dest="clip_len",
                   help="frames a clip (default: the preset's)")
    x.add_argument("--set", action="append", metavar="SEC.KEY=VAL")
    _device_arg(x)
    x.set_defaults(fn=cmd_export)

    cv = sub.add_parser("convert", help="a reference-format .pth as a "
                                        "training checkpoint")
    cv.add_argument("torch_checkpoint")
    cv.add_argument("--out", default="converted_ckpt",
                    help="run directory (eval --out, train --resume)")
    cv.add_argument("--family", default="d", choices=list("abcde"),
                    help="which family the .pth belongs to")
    cv.add_argument("--preset", default=None,
                    help="the model config's preset (default: family_<f>)")
    cv.add_argument("--set", action="append", metavar="SEC.KEY=VAL")
    cv.set_defaults(fn=cmd_convert)

    sv = sub.add_parser("serve", help="HTTP scoring endpoint")
    sv.add_argument("model", help="reference-format .pth checkpoint or an "
                                  "exported scorer (cli export)")
    sv.add_argument("--family", default="d",
                    help="model family of a .pth: 'd' (default) or 'b' "
                         "(A, C and E serve from an exported scorer)")
    _device_arg(sv)
    sv.add_argument("--probe-timeout", type=float, default=120.0,
                    dest="probe_timeout",
                    help="seconds for the device check before the model "
                         "loads, when serving on CUDA (0 skips it)")
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

    d = sub.add_parser("diagnose", help="warnings from a training history")
    d.add_argument("history")
    d.set_defaults(fn=cmd_diagnose)

    sm = sub.add_parser("smoke", help="pre-training model + dataset gate")
    sm.add_argument("--data-root", default=None)
    sm.add_argument("--dataset", default="ucsd_ped2")
    _device_arg(sm)
    sm.set_defaults(fn=cmd_smoke)

    pl = sub.add_parser("plots", help="a history's dashboard, or family C's "
                                      "per-block correlations")
    pl.add_argument("history", nargs="?", default=None)
    pl.add_argument("--out", default="training_results.png")
    pl.add_argument("--block-correlation", action="store_true",
                    dest="block_correlation",
                    help="per-conv-block channel-correlation heatmaps")
    pl.add_argument("--run", default=None,
                    help="training run dir whose checkpoint to analyze "
                         "(omit for a fresh-init structure figure)")
    pl.add_argument("--step", default="latest",
                    help="checkpoint to restore: latest|best|mid|<epoch>")
    pl.add_argument("--preset", default="family_c")
    pl.add_argument("--data-root", default=None, dest="data_root")
    pl.add_argument("--set", action="append", default=[],
                    help="config override SEC.KEY=VAL (repeatable)")
    _device_arg(pl)
    pl.set_defaults(fn=cmd_plots)

    dr = sub.add_parser("doctor", help="environment report (decoder, "
                                       "optional modules, CUDA devices)")
    dr.add_argument("--probe-timeout", type=float, default=60.0)
    dr.set_defaults(fn=cmd_doctor)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
