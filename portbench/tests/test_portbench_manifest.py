"""`BENCHMARK.json` against the benchmark's contract: names, units, files,
the metrics' cells, the time budget."""

import json
import math
import re

from portbench import harness

B = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_tok)")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(B["command"]) <= 32 and all(map(line, B["command"]))
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
        assert (harness.ROOT / p).is_dir()
    for word in B["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in B["paths"])


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in B[k]}) == len(B[k])
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in B["configs"] + B["workloads"]:
        assert line(x["why"])
    for m in B["per_layer"]:
        assert line(m["layer"])


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and line(c["source"])
        assert c["file"].startswith(B["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(B["workloads"])
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        cell = harness.cell(w["name"])  # every file it names exists
        assert cell["limits"], "each cell compares at least one number"
        assert (harness.BENCH / "drivers" /
                f"{cell['traffic']['driver']}.py").is_file()


def test_metrics_cells_and_moves():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moves = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in moves.get("workloads", cells), (m["name"], w)
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # setup_s, another end-to-end metric, a per-layer one
        reported = [m for m in B["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in B["per_layer"])


def test_run_seconds_budget():
    s = B["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each s + 60 seconds,
    # 2 x 90 s of compiling a cell, and 1,200 s spare
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200
