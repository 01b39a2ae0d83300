"""Training-history diagnosis, the dataset dtype audit and the model smoke
test.

Port of `cvad_tpu/utils/diagnose.py`: `diagnose_training_issues`
(``avenue_training_script2.py:474-517``, structured findings: the loss's
reduction, the loss components' balance, dead-evaluation and
score-collapse warnings) over any history in the reference's schema (the
port's `runtime/history.py` writes it), `debug_dataset_dtypes`
(``minicausal_vad_complete3.py:435-456``) and `smoke_test_model`
(``:458-501``), which runs the port's family C on the device the caller
names.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np

from cvad_tpu_torch.utils.json_utils import safe_json_load


def diagnose_training_issues(history: Optional[Mapping] = None,
                             history_file: Optional[str] = None,
                             verbose: bool = True) -> Dict:
    """Analyze a training history; returns {metrics, warnings}."""
    if history is None:
        history = safe_json_load(history_file)
        if history is None:
            if verbose:
                print(f"history file not found or unreadable: {history_file}")
            return {"metrics": {}, "warnings": ["history unreadable"]}

    warnings: List[str] = []
    metrics: Dict[str, float] = {}

    losses = list(history.get("train_losses", []))
    if len(losses) > 10:
        initial = float(np.mean(losses[:5]))
        final = float(np.mean(losses[-5:]))
        reduction = (initial - final) / initial * 100 if initial else 0.0
        metrics["loss_reduction_pct"] = reduction
        if reduction < 10:
            warnings.append("minimal loss reduction (<10%)")

    comps = history.get("loss_components", [])
    if comps:
        latest = {k: v for k, v in comps[-1].items()
                  if isinstance(v, (int, float))}
        total = sum(abs(v) for v in latest.values())
        balance = {k: (abs(v) / total * 100 if total else 0.0)
                   for k, v in latest.items()}
        metrics["component_balance_pct"] = balance
        if balance.get("sparsity_loss", 0) > 80:
            warnings.append("sparsity loss dominates — reduce sparsity_weight")
        if balance.get("acyclicity_loss", 0) > 90:
            warnings.append("acyclicity loss dominates — reduce causal_weight")

    evals = history.get("evaluation_metrics", [])
    if evals:
        ranges = [e.get("score_range") for e in evals
                  if e.get("score_range") is not None]
        if ranges and all(r < 1e-4 for r in ranges[-3:]):
            warnings.append("score range collapsed — model outputs constant")
        means = [e.get("mean_score", 0.0) for e in evals]
        if means and all(m == 0.0 for m in means):
            warnings.append("all evaluation scores are zero — model not learning")

    if verbose:
        print("TRAINING DIAGNOSIS")
        for k, v in metrics.items():
            print(f"  {k}: {v}")
        for w in warnings:
            print(f"  WARNING: {w}")
        if not warnings:
            print("  no issues detected")
    return {"metrics": metrics, "warnings": warnings}


def debug_dataset_dtypes(dataset, num_samples: int = 3,
                         verbose: bool = True) -> List[Dict]:
    """Dataset dtype audit (``minicausal_vad_complete3.py:435-456``):
    loads N samples, records shape/dtype/range, flags float64 leakage.
    Returns one dict per sample instead of only printing."""
    out: List[Dict] = []
    for i in range(min(num_samples, len(dataset))):
        try:
            data, label = dataset[i]
            data = np.asarray(data)
            rec = {"index": i, "shape": tuple(data.shape),
                   "dtype": str(data.dtype),
                   "min": float(data.min()), "max": float(data.max()),
                   "float64": data.dtype == np.float64
                   or getattr(label, "dtype", None) == np.float64}
            if verbose:
                flag = "  WARNING: float64 leakage" if rec["float64"] else ""
                print(f"sample {i}: {rec['shape']} {rec['dtype']} "
                      f"[{rec['min']:.6f}, {rec['max']:.6f}]{flag}")
        except Exception as e:  # noqa: BLE001 — the reference printed and
            # went on: one unreadable sample is a finding, not an abort
            rec = {"index": i, "error": str(e)}
            if verbose:
                print(f"sample {i}: load error: {e}")
        out.append(rec)
    return out


def smoke_test_model(verbose: bool = True, device=None) -> Dict:
    """Pre-training model smoke test (``minicausal_vad_complete3.py:458-501``,
    the reference's family-C gate): every parameter float32, and a random
    ``(2, 8, 64, 64, 1)`` clip batch (normal draws, seed 0) through the
    eval forward of a freshly initialised family C on `device` (CUDA by
    default): output shape (2, 1), values in [0, 1], no NaN or Inf.
    Returns {ok, param_dtype_issues, output_*}."""
    import torch

    from cvad_tpu_torch.models import Simple3DCNNDetector
    from cvad_tpu_torch.runtime.device import resolve_device
    from cvad_tpu_torch.train.tasks import card_numerics

    dev = resolve_device(device)
    model = Simple3DCNNDetector(seed=0).to(dev).eval()
    issues = [name for name, p in model.named_parameters()
              if p.dtype != torch.float32]
    x = np.random.default_rng(0).normal(size=(2, 8, 64, 64, 1)).astype(
        np.float32)
    with torch.inference_mode(), card_numerics():
        s = model(torch.from_numpy(x).to(dev).permute(0, 4, 1, 2, 3)
                  .contiguous()).cpu().numpy()
    result = {
        "ok": (not issues and s.shape == (2, 1)
               and bool(np.all((s >= 0) & (s <= 1)))
               and bool(np.all(np.isfinite(s)))),
        "param_dtype_issues": issues,
        "output_shape": tuple(s.shape),
        "output_range": (float(s.min()), float(s.max())),
        "has_nan": bool(np.isnan(s).any()),
        "has_inf": bool(np.isinf(s).any()),
        "device": str(dev),
    }
    if verbose:
        status = "passed" if result["ok"] else "FAILED"
        print(f"model smoke test {status}: output {result['output_shape']} "
              f"range [{result['output_range'][0]:.6f}, "
              f"{result['output_range'][1]:.6f}] on {dev}")
        for name in issues:
            print(f"  WARNING: non-float32 param {name}")
    return result
