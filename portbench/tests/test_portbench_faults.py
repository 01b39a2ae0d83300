"""Whole runs of each cell at a small size on the CPU, skipping only the
look for a card: sound, `correct` is true; with the timed path broken
underneath, `correct` comes out false, for each fault the cell can have
(a step that returns its state unchanged; half of the batch left out, the
mean taken over the rest; an answer altered where it is produced).  One
card: no exchange between chips to leave out."""

import json

import pytest
import torch

import portbench.run as run
from portbench import trace
from portbench.tests.small import small_cell


def stale_state(kind, trainer):
    """Every step computes its metrics and leaves the state as it was."""
    if kind != "trainer":
        return
    task, step = trainer.task, trainer.task.train_step

    def train_step(state, batch, seed, gen=None):
        saved = [t.detach().clone() for t in state.model.state_dict()
                 .values()]
        moments = [state.opt_state.mu.clone(), state.opt_state.nu.clone()]
        state, metrics = step(state, batch, seed, gen)
        with torch.no_grad():
            for t, s in zip(state.model.state_dict().values(), saved):
                t.copy_(s)
            state.opt_state.mu.copy_(moments[0])
            state.opt_state.nu.copy_(moments[1])
        return state, metrics

    task.train_step = train_step


def half_batch(kind, trainer):
    """Every step trains on the first half of its rows."""
    if kind != "trainer":
        return
    task, step = trainer.task, trainer.task.train_step

    def train_step(state, batch, seed, gen=None):
        half = batch["clips"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, seed,
                    gen)

    task.train_step = train_step


def altered_answer(kind, service):
    """The scorer's answers moved by 1e-3 where they are produced."""
    if kind != "service":
        return
    fn = service.score_fn
    service.score_fn = lambda clips: fn(clips) + 1e-3


def result(capsys, name, fault=None, trace=0, seconds=1):
    rc = run.main(["--workload", name, "--seed", "4294967311", "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  cell=small_cell(name), fault=fault)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    assert list(line)[-1] == "checks"
    return line


# the bf16 cell's limits are set from the card's bf16 convolutions, which
# the CPU's do not reproduce: its sound runs are the card's to show
@pytest.mark.parametrize("name", ["train-d-b256", "train-a-b4-k4",
                                  "serve-a-cameras"])
def test_sound_run_is_correct(capsys, name):
    line = result(capsys, name)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0


@pytest.mark.parametrize("name", ["train-d-b256", "train-a-b4-k4",
                                  "train-d-b256-bf16-k4"])
@pytest.mark.parametrize("fault", [stale_state, half_batch])
def test_train_fault_is_caught(capsys, name, fault):
    assert result(capsys, name, fault)["correct"] is False


def test_altered_answer_is_caught(capsys):
    assert result(capsys, "serve-a-cameras", altered_answer)[
        "correct"] is False


def test_traced_run_reports_per_layer_metrics(capsys, monkeypatch):
    monkeypatch.setattr(trace, "SLICE_S", 0.2)
    line = result(capsys, "train-d-b256", trace=1, seconds=1)
    assert "mfu.train" in line["metrics"]
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
