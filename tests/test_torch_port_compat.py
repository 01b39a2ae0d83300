"""The port's reference-API layer (`cvad_tpu_torch.compat`) against
`cvad_tpu.compat`, on the CPU: the five tests of `tests/test_compat.py`
for the port, with the drivers and the models held against `cvad_tpu`'s.

`cvad_tpu`'s side is one `ImprovedMiniCausalVAD` (two JAX compiles: its
train and eval steps) on the fixture's weights, dropout off, over two
batches of (4, 3, 8, 16, 16) clips with injected pseudo-targets, one in
each layout: the eval before training, 2 epochs of
``train_epoch_improved`` (each epoch's loss, components and plateau lr),
the parameters and the eval after.  The drivers' loops are held against
`cvad_tpu`'s by running `cvad_tpu`'s loop over the port's model class
(the loop is what is compared): the same files and history, up to the
timestamps.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cvad_tpu_torch import compat
from cvad_tpu_torch.compat import (ImprovedMiniCausalVAD, MiniCausalVAD,
                                   create_unsupervised_labels,
                                   setup_training_environment,
                                   train_improved_minicausal_vad,
                                   train_minicausal_vad_on_avenue)
from cvad_tpu_torch.compat import test_trained_model as eval_trained_model
from cvad_tpu_torch.config import preset

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "runs" / "dyn_parity_d" / "ours" / "best_improved_model.pth"
EPOCHS = 2


def _loader(n_batches=2, b=4, torch_layout=True):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_batches):
        clips = rng.uniform(0, 1, (b, 3, 8, 16, 16)).astype(np.float32)
        if not torch_layout:
            clips = np.transpose(clips, (0, 2, 3, 4, 1))
        out.append((clips, np.zeros(b, np.float32)))
    return out


def _parity_batches() -> list:
    """Two dict batches with injected pseudo-targets: torch layout, then
    channels-last."""
    rng = np.random.default_rng(1)
    out = []
    for torch_layout in (True, False):
        clips = rng.uniform(0, 1, (4, 3, 8, 16, 16)).astype(np.float32)
        if not torch_layout:
            clips = np.transpose(clips, (0, 2, 3, 4, 1))
        out.append({"clips": clips, "labels": np.zeros(4, np.float32),
                    "pseudo_targets": np.array([1, 0, 0, 1], np.float32)})
    return out


def _drive(model, batches: list) -> dict:
    """Eval, `EPOCHS` epochs of ``train_epoch_improved``, eval: the same
    calls on either framework's model."""
    out = {"eval0": model.evaluate_improved(batches)[:2], "epochs": []}
    for _ in range(EPOCHS):
        loss, comps = model.train_epoch_improved(batches)
        out["epochs"].append((loss, comps,
                              model.optimizer.param_groups[0]["lr"]))
    out["eval1"] = model.evaluate_improved(batches)
    out["params"] = {k: np.asarray(v)
                     for k, v in model.model.state_dict().items()}
    return out


@pytest.fixture(scope="module")
def jax_run():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from cvad_tpu.compat import ImprovedMiniCausalVAD as JaxImproved
    from cvad_tpu.config import preset as jax_preset

    cfg = jax_preset("avenue_improved")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
    model = JaxImproved(device="cpu", cfg=cfg)
    model.load_model(str(FIXTURE))
    with jax.default_matmul_precision("highest"):
        return _drive(model, _parity_batches())


def _port_model(cls=ImprovedMiniCausalVAD):
    cfg = preset("avenue_improved")
    return cls(device="cpu",
               cfg=cfg.replace(model=cfg.model.replace(dropout=0.0)))


def test_minicausal_vad_interface(tmp_path, jax_run):
    """The reference's interface on the port (tests/test_compat.py), and
    the model held against `cvad_tpu`'s from the fixture's weights: the
    eval before training, each epoch's loss and components (1e-4
    relative) and plateau lr (equal), the parameters after (5e-5), the
    predictions and graphs after (1e-4)."""
    model = MiniCausalVAD(device="cpu")
    loader = _loader()
    loss, comps = model.train_epoch(loader)
    assert np.isfinite(loss)
    assert {"anomaly_loss", "acyclicity_loss", "sparsity_loss",
            "consistency_loss"} <= set(comps)
    predictions, _, causal_graphs = model.evaluate(loader)
    assert predictions.shape == (8,)
    assert causal_graphs.shape == (8, 16, 16)
    assert sum(p.numel() for p in model.model.parameters()) == 188_849
    for pg in model.optimizer.param_groups:
        pg["lr"] = 1e-4
    assert abs(model.optimizer.param_groups[0]["lr"] - 1e-4) < 1e-9
    assert float(model.state.opt_state.lr) == pytest.approx(1e-4)
    p = tmp_path / "m.pth"
    model.save_model(str(p))
    assert set(torch.load(p, weights_only=True)) == {"model_state_dict"}
    model2 = MiniCausalVAD(device="cpu")
    model2.load_model(str(p))
    pred2, _, _ = model2.evaluate(loader)
    np.testing.assert_allclose(pred2, predictions, atol=1e-5)

    port = _port_model()
    port.load_model(str(FIXTURE))
    got = _drive(port, _parity_batches())
    for a, b in zip(got["eval0"] + got["eval1"][:2],
                    jax_run["eval0"] + jax_run["eval1"][:2]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    for (loss, comps, lr), (jloss, jcomps, jlr) in zip(got["epochs"],
                                                       jax_run["epochs"]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        assert sorted(comps) == sorted(jcomps)
        for k in comps:
            np.testing.assert_allclose(comps[k], jcomps[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        assert lr == jlr
    assert sorted(got["params"]) == sorted(jax_run["params"])
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, jax_run["params"][k], rtol=0,
                                   atol=5e-5, err_msg=k)
    for k, v in got["eval1"][2].items():
        np.testing.assert_allclose(v, jax_run["eval1"][2][k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_improved_interface():
    model = ImprovedMiniCausalVAD(device="cpu")
    loader = _loader(torch_layout=False)
    loss, comps = model.train_epoch_improved(loader)
    assert np.isfinite(loss)
    preds, graphs, metrics = model.evaluate_improved(loader)
    assert set(metrics) == {"mean_score", "std_score", "min_score",
                            "max_score", "score_range", "avg_edges",
                            "avg_sparsity", "unique_graphs"}
    total, c = model.compute_improved_loss(preds, graphs,
                                           np.zeros(len(preds)))
    assert np.isfinite(total) and "edge_count" in c


def test_create_unsupervised_labels():
    model = MiniCausalVAD(device="cpu")
    loader = _loader(n_batches=3)
    scores, pseudo, threshold = create_unsupervised_labels(loader, model, 95)
    assert scores.shape == (12,)
    assert set(np.unique(pseudo)) <= {0.0, 1.0}
    assert pseudo.sum() <= max(1, int(0.1 * len(pseudo)) + 1)
    np.testing.assert_array_equal(pseudo, scores > threshold)
    np.testing.assert_allclose(scores, model.evaluate(loader)[0])


def _run_jax_driver(monkeypatch, name: str, cls, out: Path, **kw):
    """`cvad_tpu`'s driver loop `name` over the port's model class on the
    CPU."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    import cvad_tpu.compat as jax_compat

    monkeypatch.setattr(jax_compat, cls.__name__,
                        lambda: cls(device="cpu"))
    return getattr(jax_compat, name)("unused", output_dir=str(out), **kw)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_improved_driver(tmp_path, monkeypatch, version):
    """Both drivers (tests/test_compat.py's v2 checks), against
    `cvad_tpu`'s loop over the port's model: the same file names, the same
    history keys and, but the timestamps, the same history."""
    loaders = (_loader(2, 4), _loader(1, 4))
    if version == "v2":
        fn, cls, name = (train_improved_minicausal_vad, ImprovedMiniCausalVAD,
                         "improved_training_history.json")
        kw = dict(num_epochs=2, save_interval=1, loaders=loaders)
    else:
        fn, cls, name = (train_minicausal_vad_on_avenue, MiniCausalVAD,
                         "training_history.json")
        kw = dict(num_epochs=2, save_interval=1, learning_rate=1e-4,
                  loaders=loaders)
    model, history = fn("unused", output_dir=str(tmp_path / "port"),
                        device="cpu", **kw)
    assert history["epochs"] == [1, 2]
    if version == "v2":
        assert len(history["evaluation_metrics"]) >= 1
    else:
        assert model.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    assert (tmp_path / "port" / name).exists()
    assert (tmp_path / "port" / "checkpoint_epoch_0.pth").exists()
    _, ref = _run_jax_driver(monkeypatch, fn.__name__, cls,
                             tmp_path / "ref", **kw)
    files = {d: sorted(p.name for p in (tmp_path / d).iterdir())
             for d in ("port", "ref")}
    assert files["port"] == files["ref"]
    saved = json.loads((tmp_path / "port" / name).read_text())
    assert sorted(saved) == sorted(ref) == sorted(history)
    history.pop("timestamps", None)
    ref.pop("timestamps", None)
    assert json.dumps(history) == json.dumps(ref)


def test_setup_environment_and_test_trained_model(tmp_path, capsys):
    """The drivers' tail (avenue_training_script1.py:23-35, :293-313): the
    device probe (CUDA by default, which raises without a card) and a
    checkpoint loaded and evaluated; the fixture loads strictly too."""
    assert setup_training_environment("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            setup_training_environment()
    assert compat.test_trained_model.__test__ is False

    model = MiniCausalVAD(device="cpu")
    loader = _loader()
    model.train_epoch(loader)
    p = tmp_path / "best_model.pth"
    model.save_model(str(p))
    ref_pred, _, ref_graphs = model.evaluate(loader)

    predictions, causal_graphs = eval_trained_model(
        str(p), "unused", loaders=(loader, loader), device="cpu")
    np.testing.assert_allclose(predictions, ref_pred, atol=1e-5)
    assert causal_graphs.shape == ref_graphs.shape
    assert "avg causal edges" in capsys.readouterr().out
    fixture, _ = eval_trained_model(str(FIXTURE), "unused",
                                    loaders=(loader, loader), device="cpu")
    assert fixture.shape == (8,) and np.isfinite(fixture).all()
