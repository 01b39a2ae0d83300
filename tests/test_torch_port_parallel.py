"""The port's multi-device layer on gloo CPU worlds: N-rank steps against
the one-rank step and against `cvad_tpu`'s mesh, the temporal halo
forward, the trainer over a mesh, the dry run and `torchrun`.

Five worlds are spawned once, all at the same time, by the module's
`worlds` fixture: the steps (2 ranks), the trainer (2), the time axis (4)
(`parallel/dryrun.py::run_world`), the dry run (2) and `torchrun` (2).
Each rank writes its results under the fixture's directory and the tests
compare them here, against the one-rank step computed in this process,
while the worlds run, on the trivial 1 x 1 mesh (no process group) from
the same seed, the same global batch and dropout on.  Each world has a
deadline, so a hang fails.  Tolerances are `cvad_tpu`'s own tests'
(`tests/test_parallel.py`, `tests/test_temporal.py`): the ranks sum
BatchNorm statistics and gradients in another order than one process,
while the replicas, which all-reduce the same sums, agree bit for bit.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import preset
from cvad_tpu_torch.parallel.dryrun import dryrun_multichip, run_world
from cvad_tpu_torch.runtime.mesh import (create_mesh, pad_with_valid,
                                         shard_batch, single_mesh)
from cvad_tpu_torch.train.tasks import build_task

ROOT = Path(__file__).resolve().parent.parent

# name -> (family, global rows); 'd13' pads 13 rows to 14 on 2 ranks,
# 'd_jax' injects pseudo-labels with dropout off (cvad_tpu's step)
CASES = {"d": ("d", 8), "d13": ("d", 13), "d_jax": ("d", 8),
         "b": ("b", 8), "c": ("c", 8), "a": ("a", 4)}
SCORE_CLIPS = 5  # padded to 6 on 2 ranks, trimmed back


def _cfg(case: str):
    fam = CASES[case][0]
    if fam == "d":
        cfg = preset("family_d")
        cfg = cfg.replace(data=cfg.data.replace(frame_size=(16, 16)))
        if case == "d_jax":
            cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
        return cfg
    if fam == "b":  # narrowed; the model's decoder needs 64 x 64 frames
        cfg = preset("memory_ae")
        return cfg.replace(
            model=cfg.model.replace(conv_channels=(8, 16, 32, 32),
                                    latent_dim=16, lstm_hidden=16),
            data=cfg.data.replace(clip_len=4),
            optim=cfg.optim.replace(lr=1e-4))
    if fam == "c":
        cfg = preset("mini3d")
        return cfg.replace(data=cfg.data.replace(frame_size=(16, 16)))
    cfg = preset("causal_pipeline")
    return cfg.replace(data=cfg.data.replace(frame_size=(32, 48),
                                             clip_len=4))


def _host(case: str) -> dict:
    """The global batch of a case, padded to 2 ranks with its mask."""
    fam, n = CASES[case]
    d = _cfg(case).data
    rng = np.random.default_rng(list(CASES).index(case))
    batch = {"clips": rng.integers(0, 256, (n, d.clip_len, *d.frame_size,
                                            d.channels), dtype=np.uint8),
             "labels": (np.arange(n) % 3 == 1).astype(np.float32)}
    if case == "d_jax":
        batch["pseudo_targets"] = (rng.uniform(size=n) < 0.25).astype(
            np.float32)
    return pad_with_valid(batch, 2)


def _tensors(batch: dict, device: str = "cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _step(case: str, mesh, device: str = "cpu") -> dict:
    """One train step of a case from seed 0 on this rank's part of its
    global batch (and family B's eval step after it)."""
    task = build_task(_cfg(case), mesh)
    state = task.init_state(0, device)
    batch = _tensors(shard_batch(mesh, _host(case)), device)
    state, metrics = task.train_step(state, batch, 1)
    out = {"state": state.state_dict(),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    if case == "b":
        out["eval"] = {k: v.cpu().numpy() for k, v in
                       task.eval_step(state, batch).items()}
    return out


def _score_inputs(family: str):
    from cvad_tpu_torch.models.registry import build_model

    cfg = _cfg(family)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        state = build_model(cfg.model).state_dict()
    d = cfg.data
    clips = np.random.default_rng(9).uniform(
        0, 1, (SCORE_CLIPS, d.clip_len, *d.frame_size, d.channels)).astype(
            np.float32)
    return state, cfg.model, clips


def _scores(mesh) -> dict:
    from cvad_tpu_torch.evaluation.scoring import (make_score_fn,
                                                   make_sharded_score_fn)

    out = {}
    for fam in ("d", "c"):
        state, model_cfg, clips = _score_inputs(fam)
        fn = (make_score_fn(fam, state, cfg=model_cfg, device="cpu")
              if mesh is None else
              make_sharded_score_fn(state, mesh, fam, model_cfg,
                                    device="cpu"))
        out[fam] = fn(clips)
    return out


def _counts() -> dict:
    """The collectives' call counters."""
    from cvad_tpu_torch.parallel.collectives import counters

    return {k: getattr(o, a) for k, (o, a) in counters().items()}


def steps_rank(rank: int, world: int, out: str) -> None:
    mesh = create_mesh()
    res = {"steps": {case: _step(case, mesh) for case in CASES},
           "scores": _scores(mesh), "counts": _counts()}
    torch.save(res, Path(out) / f"{rank}.pt")


class Worlds:
    """The five worlds' outcomes; `get` re-raises a world's failure in the
    tests that read it."""

    def __init__(self, out: Path, futures: dict, refs: dict):
        self.out, self.refs = out, refs
        self.errors = {k: f.exception() for k, f in futures.items()}
        self.results = {k: f.result() for k, f in futures.items()
                        if self.errors[k] is None}

    def get(self, name: str):
        if self.errors[name] is not None:
            raise self.errors[name]
        return self.results[name]

    def ranks(self, name: str, world: int) -> list:
        self.get(name)
        return [torch.load(self.out / name / f"{r}.pt", weights_only=False)
                for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("worlds")
    for name in ("steps", "trainer", "time"):
        (out / name).mkdir()
    with ThreadPoolExecutor(5) as pool:
        futures = {
            "steps": pool.submit(run_world, steps_rank, 2,
                                 str(out / "steps"), timeout=240),
            "trainer": pool.submit(run_world, trainer_rank, 2,
                                   str(out / "trainer"), timeout=240),
            "time": pool.submit(run_world, time_rank, 4, str(out / "time"),
                                timeout=240),
            "dryrun": pool.submit(dryrun_multichip, 2),
            "torchrun": pool.submit(_torchrun, out / "cli")}
        # the one-rank references, while the worlds run
        refs = {"steps": {case: _step(case, single_mesh())
                          for case in CASES},
                "fit": _fit(out / "one", "full")}
        return Worlds(out, futures, refs)


@pytest.fixture(scope="module")
def steps(worlds):
    return worlds.ranks("steps", 2), worlds.refs["steps"]


def _close(a: dict, b: dict, rtol: float, atol: float) -> None:
    for k in a:
        np.testing.assert_allclose(a[k].float().numpy(),
                                   b[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# (loss atol, parameter rtol, atol): tests/test_parallel.py's; family B's
# parameters at its lr 1e-4 for BN reduction order (:119-159)
TOL = {"d": (1e-5, 2e-4, 2e-5), "d13": (1e-5, 2e-4, 2e-5),
       "c": (1e-5, 2e-4, 2e-5), "a": (1e-5, 2e-4, 2e-5),
       "b": (1e-5, 2e-3, 2e-4)}
# Family A's 7.9 M parameters: Adam's first step moves each by about
# lr * sign(g), so an entry whose gradient is within rounding of 0 can
# move the other way when the ranks sum in another order (the rule of
# tests/test_torch_port_train_a.py): every entry within 2 lr, and at most
# this share beyond the tolerance
FAR_SHARE_A = 1e-5


def _close_params(case: str, got: dict, want: dict, rtol: float,
                  atol: float) -> None:
    if case != "a":
        _close(got, want, rtol, atol)
        return
    lr, far, total = _cfg("a").optim.lr, 0, 0
    for k, v in got.items():
        d = (v - want[k]).abs()
        assert float(d.max()) <= 2 * lr, k
        far += int((d > atol + rtol * want[k].abs()).sum())
        total += v.numel()
    assert far <= FAR_SHARE_A * total, (far, total)


@pytest.mark.parametrize("case", sorted(TOL))
def test_two_rank_step_matches_one_rank(steps, case):
    """Dropout on (family D, C, A's draws through `RowDraws`), the same
    seed and global batch: the metrics, parameters, BatchNorm statistics,
    bank and Adam moments of the 2-rank step are the 1-rank step's; 'd13'
    is a remainder batch padded to 14 (its padded row masked out)."""
    ranks, one = steps
    got, want = ranks[0]["steps"][case], one[case]
    loss_atol, rtol, atol = TOL[case]
    assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) < loss_atol
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, want["metrics"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    g, w = got["state"]["model_state_dict"], want["state"]["model_state_dict"]
    bank = {k for k in g if "memory" in k}
    stats = {k for k in g if "running" in k}
    params = {k: g[k] for k in g if k not in bank | stats
              and "num_batches" not in k}
    _close_params(case, params, w, rtol, atol)
    _close({k: g[k] for k in stats}, w, 1e-4, 1e-5)
    _close({k: g[k] for k in bank}, w, 1e-4, 1e-5)
    if case == "b":  # every clip's features in the bank, pointer and fill
        n_normal = int((_host("b")["labels"] == 0).sum())
        assert int(g["memory_ptr"]) == int(w["memory_ptr"]) == n_normal
        assert int(g["memory_fill"]) == int(w["memory_fill"]) == n_normal
    go, wo = got["state"]["optimizer"], want["state"]["optimizer"]
    np.testing.assert_allclose(go["mu"].numpy(), wo["mu"].numpy(),
                               rtol=1e-3, atol=1e-6)
    assert int(go["count"]) == int(wo["count"]) == 1


def test_replicas_are_bit_identical(steps):
    """After every case's step both ranks hold the same parameters,
    BatchNorm statistics, bank and optimizer state, bit for bit, and the
    same metrics: they reduced the same sums."""
    ranks, _ = steps
    for case in CASES:
        a, b = (r["steps"][case] for r in ranks)
        assert a["metrics"] == b["metrics"], case
        for part in ("model_state_dict", "optimizer"):
            for k, v in a["state"][part].items():
                assert torch.equal(v, b["state"][part][k]), (case, k)


def test_family_b_eval_gathers_every_rank(steps):
    """Family B's eval step after the step: each rank's rows scored
    against the replicated bank (K3's plain version here), every output
    gathered in row order with the valid mask."""
    ranks, one = steps
    got, want = ranks[0]["steps"]["b"]["eval"], one["b"]["eval"]
    assert sorted(got) == sorted(want)
    assert got["predictions"].shape == (CASES["b"][1],)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(ranks[1]["steps"]["b"]["eval"]["valid"],
                                  got["valid"])


def test_collectives_were_called(steps):
    """Each rank's steps went through the collectives: one gradient
    all-reduce a step, gathers and their backward sums, BatchNorm's
    all-reduce in families B, C and A."""
    ranks, _ = steps
    c = ranks[0]["counts"]
    assert c["reduce_gradients"] == len(CASES)
    assert c["gather"] > 0 and c["gather_backward"] > 0
    assert c["all_reduce_sum"] > 0 and c["all_reduce_sum_backward"] > 0
    assert ranks[1]["counts"] == c


@pytest.mark.parametrize("family", ["d", "c"])
def test_sharded_scorer_matches_plain(steps, family):
    """`make_sharded_score_fn` on 2 ranks (5 clips padded to 6, trimmed)
    equals the family's plain scorer on one process."""
    ranks, _ = steps
    want = _scores(None)[family]
    for r in ranks:
        got = r["scores"][family]
        if family == "d":
            assert got[0].shape == (SCORE_CLIPS,)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert got.shape == (SCORE_CLIPS,)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_two_rank_step_matches_jax_mesh(steps):
    """Family D's 2-rank step against `cvad_tpu`'s step on a 2-device CPU
    mesh from the same parameters, with the pseudo-labels injected and
    dropout off (the frameworks draw different bits)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.runtime.mesh import (batch_sharding,
                                       create_mesh as jax_mesh, replicated,
                                       shard_batch as jax_shard)
    from cvad_tpu.train.state import make_state
    from cvad_tpu.train.tasks import build_task as jax_task
    from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_d,
                                                   to_jax_family_d)

    ranks, one = steps
    init = build_task(_cfg("d_jax")).init_state(0, "cpu")
    jcfg = jax_preset("family_d")
    jcfg = jcfg.replace(model=jcfg.model.replace(dropout=0.0),
                        data=jcfg.data.replace(frame_size=(16, 16)))
    task = jax_task(jcfg)
    params = jax.tree.map(jnp.asarray, to_jax_family_d(
        init.model.state_dict())["params"])
    mesh = jax_mesh(devices=jax.devices("cpu")[:2])
    rep = replicated(mesh)
    state = jax.device_put(make_state(params, task.tx), rep)
    step = jax.jit(task.train_step,
                   in_shardings=(rep, batch_sharding(mesh), rep))
    with jax.default_matmul_precision("highest"):
        new, metrics = step(state, jax_shard(mesh, _host("d_jax")),
                            jax.device_put(jax.random.key(1), rep))
    got = ranks[0]["steps"]["d_jax"]
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, float(metrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = from_jax_family_d({"params": jax.device_get(new.params)})
    _close(got["state"]["model_state_dict"], want, 2e-4, 2e-5)


# -- the trainer over a 2-rank mesh ------------------------------------------

TRAIN_CLIPS, EVAL_CLIPS = 10, 5


def _train_cfg(out: Path, name: str, epochs: int = 2, clip_len: int = 8,
               **parallel):
    cfg = preset("family_d")
    return cfg.replace(
        data=cfg.data.replace(batch_size=4, frame_size=(16, 16),
                              clip_len=clip_len, transfer_dtype="uint8"),
        parallel=cfg.parallel.replace(**parallel),
        train=cfg.train.replace(num_epochs=epochs, eval_every=1,
                                save_interval=1, save_every_steps=1,
                                log_every=10**9, steps_per_call=2,
                                device_cache="on",
                                out_dir=str(out / name)))


def _loaders(cfg):
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import SyntheticClipDataset

    d = cfg.data
    return (BatchLoader(SyntheticClipDataset(d, n=TRAIN_CLIPS,
                                             split="Train"),
                        d.batch_size, shuffle=True, seed=3,
                        transfer_dtype="uint8"),
            BatchLoader(SyntheticClipDataset(d, n=EVAL_CLIPS, split="Test"),
                        d.batch_size, transfer_dtype="uint8"))


def _time_batches() -> list:
    rng = np.random.default_rng(0)
    return [{"clips": rng.integers(0, 256, (4, 16, 16, 16, 3),
                                   dtype=np.uint8),
             "labels": np.zeros(4, np.float32)} for _ in range(2)]


def _time_epoch(out: Path, name: str, data_axis: int, temporal_axis: int):
    """One epoch of family D at T=16 over two given batches on a
    (data, time) mesh: the parameters after it."""
    from cvad_tpu_torch.train.engine import Trainer

    cfg = _train_cfg(out, name, epochs=1, clip_len=16,
                     data_axis=data_axis, temporal_axis=temporal_axis)
    cfg = cfg.replace(train=cfg.train.replace(steps_per_call=1,
                                              device_cache="off"))
    tr = Trainer(cfg, device="cpu")
    tr.init_state()
    loss = tr.train_epoch(_time_batches(), epoch=1, record=False)["loss"]
    return loss, tr.state.state_dict()["model_state_dict"]


class Interrupted(Exception):
    pass


def _fit(out: Path, name: str, epochs: int = 2, resume: bool = False,
         die_in_epoch: int = 0):
    """A fit of family D on the trainer's mesh; `die_in_epoch` > 0 ends
    the run right after that epoch's first 'mid' checkpoint."""
    from cvad_tpu_torch.train.engine import Trainer

    class Dying(Trainer):
        def _save_mid(self, epoch, count, total_vec):
            super()._save_mid(epoch, count, total_vec)
            if epoch == die_in_epoch:
                raise Interrupted

    cfg = _train_cfg(out, name, epochs)
    tr = (Dying if die_in_epoch else Trainer)(cfg, device="cpu")
    if resume:
        tr.restore()
    history = tr.fit(*_loaders(cfg))
    return history, tr.state.state_dict()


def trainer_rank(rank: int, world: int, out: str) -> None:
    out = Path(out)
    full = _fit(out, "full")
    _fit(out, "part", epochs=1)
    resumed = _fit(out, "part", resume=True)
    try:
        _fit(out, "mid", die_in_epoch=2)
    except Interrupted:
        pass
    mid = _fit(out, "mid", resume=True)
    time_ref = _time_epoch(out, f"data_only_{rank}", 2, 1)
    torch.save({"full": full, "resumed": resumed, "mid": mid,
                "data_only": time_ref}, out / f"{rank}.pt")


@pytest.fixture(scope="module")
def trainer_runs(worlds):
    return (worlds.out / "trainer", worlds.ranks("trainer", 2),
            worlds.refs["fit"])


@pytest.mark.parametrize("run", ["resumed", "mid"])
def test_trainer_resume_equals_uninterrupted(trainer_runs, run):
    """A 2-rank fit (2 epochs, K=2 steps a call, the device clip cache on
    every rank, 'mid' checkpoints every step) interrupted after epoch 1
    ('resumed'), or right after epoch 2's first 'mid' checkpoint ('mid':
    the batch index and the partial metric sum), and restored equals the
    uninterrupted run, bit for bit, on both ranks; the replicas equal
    each other."""
    _, ranks, _ = trainer_runs
    for r in ranks:
        (h_full, s_full), (h_res, s_res) = r["full"], r[run]
        assert h_full == h_res
        for part in ("model_state_dict", "optimizer"):
            for k, v in s_full[part].items():
                assert torch.equal(v, s_res[part][k]), k
    for part in ("model_state_dict", "optimizer"):
        for k, v in ranks[0]["full"][1][part].items():
            assert torch.equal(v, ranks[1]["full"][1][part][k]), k


def test_trainer_history_matches_one_rank(trainer_runs):
    """The 2-rank history (train losses, components, eval metrics over
    the gathered, trimmed eval outputs, the lr) is the 1-rank run's."""
    _, ranks, (h_one, _) = trainer_runs
    h_two = ranks[0]["full"][0]
    assert h_two["epochs"] == h_one["epochs"] == [1, 2]
    np.testing.assert_allclose(h_two["train_losses"], h_one["train_losses"],
                               rtol=1e-5, atol=1e-6)
    assert h_two["learning_rates"] == h_one["learning_rates"]
    for a, b in zip(h_two["evaluation_metrics"] + h_two["loss_components"],
                    h_one["evaluation_metrics"] + h_one["loss_components"]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_only_rank_zero_writes(trainer_runs):
    """One writer: the history and metrics.jsonl hold each epoch once,
    the checkpoints exist, the rolling 'mid' one is gone after the run."""
    out, _, _ = trainer_runs
    run = out / "full"
    kinds = [json.loads(line)["kind"] for line in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert kinds.count("epoch") == 2 and kinds.count("eval") == 2
    assert kinds.count("done") == 1
    hist = json.loads((run / "improved_training_history.json").read_text())
    assert hist["epochs"] == [1, 2]
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    assert "best" in ckpts and "step_00000002" in ckpts
    assert "mid" not in ckpts


# -- the time axis: a (2 data x 2 time) world -------------------------------

T_CLIPS = (4, 16, 32, 32, 3)  # tests/test_temporal.py's (2, 2) case


def _t_model():
    from cvad_tpu_torch.models import CausalAnomalyDetector

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return CausalAnomalyDetector().eval()


def _t_clips():
    return np.random.default_rng(0).uniform(0, 1, T_CLIPS).astype(
        np.float32)


def time_rank(rank: int, world: int, out: str) -> None:
    from cvad_tpu_torch.parallel.collectives import reduce_gradients
    from cvad_tpu_torch.parallel.temporal import temporal_sharded_forward
    from cvad_tpu_torch.train.optim import flatten

    out = Path(out)
    mesh = create_mesh(data_axis=2, temporal_axis=2)
    model = _t_model()
    s, adj, f = temporal_sharded_forward(model, _t_clips(), mesh)
    params = list(model.parameters())
    grads = torch.autograd.grad((s ** 2).sum(), params)
    g = reduce_gradients(flatten(grads), mesh)
    res = {"fwd": [o.detach() for o in (s, adj, f)], "grad": g,
           "trainer": _time_epoch(out, f"data_time_{rank}", 2, 2)}
    torch.save(res, out / f"{rank}.pt")


@pytest.fixture(scope="module")
def time_runs(worlds):
    return worlds.ranks("time", 4)


def test_temporal_forward_matches_jax(time_runs):
    """`temporal_sharded_forward` on (2 data x 2 time) ranks against
    `cvad_tpu`'s on a (2, 2) CPU mesh, same weights: features, adjacency
    and scores within 1e-4 / 1e-5, on every rank."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")

    from cvad_tpu.config import FamilyDConfig
    from cvad_tpu.parallel.temporal import temporal_sharded_forward
    from cvad_tpu.runtime.mesh import create_mesh as jax_mesh
    from cvad_tpu_torch.runtime.checkpoint import to_jax_family_d

    variables = jax.tree.map(np.asarray, to_jax_family_d(
        _t_model().state_dict()))
    mesh = jax_mesh(data_axis=2, temporal_axis=2,
                    devices=jax.devices("cpu")[:4])
    with jax.default_matmul_precision("highest"):
        ref = temporal_sharded_forward(variables, _t_clips(), mesh,
                                       FamilyDConfig())
    for r in time_runs:
        s, adj, f = (o.numpy() for o in r["fwd"])
        np.testing.assert_allclose(f, np.asarray(ref[2]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(adj, np.asarray(ref[1]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(s.reshape(-1),
                                   np.asarray(ref[0]).reshape(-1),
                                   rtol=1e-4, atol=1e-5)


def test_temporal_gradient_matches_unsharded(time_runs):
    """The gradient of sum(s^2) through the halos and the gathers, summed
    over the 4 ranks and divided by 4, is the unsharded model's (the same
    on every rank)."""
    from cvad_tpu_torch.train.optim import flatten

    model = _t_model()
    x = torch.from_numpy(_t_clips()).permute(0, 4, 1, 2, 3)
    s, _, _ = model(x)
    want = flatten(torch.autograd.grad((s ** 2).sum(),
                                       list(model.parameters())))
    for r in time_runs:
        np.testing.assert_allclose(r["grad"].numpy(), want.numpy(),
                                   rtol=2e-3, atol=1e-5)
        assert torch.equal(r["grad"], time_runs[0]["grad"])


def test_time_axis_trainer_matches_data_only(trainer_runs, time_runs):
    """An epoch of family D at T=16 on (2 data x 2 time) equals (2 data),
    dropout on (`cvad_tpu`'s test_trainer_with_time_axis_matches_data_only
    tolerances)."""
    _, ranks, _ = trainer_runs
    loss_d, want = ranks[0]["data_only"]
    for r in time_runs:
        loss_t, got = r["trainer"]
        np.testing.assert_allclose(loss_t, loss_d, rtol=2e-4)
        _close(got, want, 2e-4, 1e-6)


def _one_rank_run(mesh, out: Path, device: str) -> tuple:
    """Family D through a Trainer on `mesh`: 2 eager steps, then one
    2-step chunk (a captured graph on a card); family B: one step and the
    eval step."""
    from cvad_tpu_torch.train.engine import Trainer

    tr = Trainer(_cfg("d"), mesh=mesh, out_dir=str(out), device=device)
    tr.init_state()
    host = [shard_batch(single_mesh(), _host("d")) for _ in range(4)]
    for b in host[:2]:
        tr.task.train_step(tr.state, tr.put_batch(b), tr._seed)
    _, total, _ = tr._multi(tr.state, tr.put_chunk(host[2:]), None)
    b_run = _step("b", mesh, device)
    return tr.state.state_dict(), total.cpu(), b_run


def _world_of_one(tmp_path: Path, device: str) -> None:
    """A process group of one rank: the data axis goes through every
    collective, each an exact copy over one rank, so the steps, the
    K-step chunk, family B's bank and eval are bit-identical to the
    trivial mesh's, and the collectives counted their calls."""
    import torch.distributed as dist

    from cvad_tpu_torch.runtime.multihost import start_group

    start_group(0, 1, (tmp_path / "rendezvous").as_uri(), device)
    try:
        mesh = create_mesh()
        assert mesh.world is not None and mesh.data.group is not None
        before = _counts()
        got = _one_rank_run(mesh, tmp_path / "group", device)
        calls = {k: v - before[k] for k, v in _counts().items()}
    finally:
        dist.destroy_process_group()
    want = _one_rank_run(single_mesh(), tmp_path / "none", device)
    # 4 steps of D and B's; on a card the graph's warm-up step too
    steps = 5 + (device == "cuda")
    assert calls["reduce_gradients"] == steps and calls["gather"] > 0
    assert calls["all_reduce_sum"] > 0 and calls["halo_exchange"] == 0
    for part in ("model_state_dict", "optimizer"):
        for k, v in got[0][part].items():
            assert torch.equal(v, want[0][part][k]), k
    assert torch.equal(got[1], want[1])
    b, wb = got[2], want[2]
    assert b["metrics"] == wb["metrics"]
    for k, v in b["state"]["model_state_dict"].items():
        assert torch.equal(v, wb["state"]["model_state_dict"][k]), k
    for k, v in b["eval"].items():
        np.testing.assert_array_equal(v, wb["eval"][k])


def test_world_of_one_equals_no_group(tmp_path):
    """`_world_of_one` on gloo (the CPU)."""
    _world_of_one(tmp_path, "cpu")


@pytest.mark.cuda
def test_nccl_world_of_one_on_card(tmp_path):
    """`_world_of_one` on NCCL: the 2-step chunk is a captured CUDA graph
    with NCCL's collectives inside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _world_of_one(tmp_path, "cuda")


def test_time_axis_refused_for_families_b_c_a():
    from cvad_tpu_torch.runtime.mesh import Axis, Mesh

    mesh = Mesh(Axis(1, 0), Axis(2, 0))
    for name in ("memory_ae", "mini3d", "causal_pipeline"):
        with pytest.raises(ValueError, match="temporal_axis"):
            build_task(preset(name), mesh)


# -- the dry run and torchrun -----------------------------------------------

def test_dryrun_multichip_two_ranks(worlds):
    """`dryrun_multichip(2)`: one family-D step on 2 gloo ranks, the loss
    finite and the replicas equal (a failing rank raises here)."""
    worlds.get("dryrun")


def _torchrun(out: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "cvad_tpu_torch.cli", "train",
         "--epochs", "1", "--n-synthetic", "8", "--set",
         "data.batch_size=4", "--set", "data.frame_size=16,16",
         "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_cli_train_under_torchrun(worlds):
    """`torchrun --nproc_per_node=2 -m cvad_tpu_torch.cli train --device
    cpu` on 8 synthetic clips: one run directory, written by rank 0, and
    one JSON summary with the 2-rank mesh."""
    res = worlds.get("torchrun")
    out = worlds.out / "cli"
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1 and lines[0]["mesh"] == {"data": 2, "time": 1}
    assert np.isfinite(lines[0]["final_loss"])
    assert json.loads((out / "config.json").read_text())["parallel"][
        "data_axis"] == 0
    assert (out / "checkpoints" / "best" / "model.pth").is_file()
