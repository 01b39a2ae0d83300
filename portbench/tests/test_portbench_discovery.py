"""A cell, a configuration and a per-layer metric are added as new files
(and their entries in `BENCHMARK.json`), with no edit to a file the
benchmark already has."""

import json
import shutil
import subprocess
import sys

from portbench import harness


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    bench = harness.benchmark()
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "family_d.json").read_text())
    cfg.update(name="family_d_gray", reduced=[])
    (pb / "configs" / "family_d_gray.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "train-b256-k1-f32.json")
                         .read_text())
    traffic["batch"] = 128
    (pb / "traffic" / "train-b128-k1-f32.json").write_text(
        json.dumps(traffic))
    (pb / "limits" / "train-dg-b128.json").write_text(
        json.dumps({"loss_gap": 1e-4}))
    (pb / "metrics" / "clips_per_step.train.py").write_text(
        "def read(ctx, trace, out):\n"
        "    return ctx.traffic['batch']\n")
    bench["configs"].append({"name": "family_d_gray", "source":
                             bench["configs"][0]["source"],
                             "file": "portbench/configs/family_d_gray.json",
                             "reduced": [], "why": "a new configuration"})
    bench["workloads"].append({"name": "train-dg-b128",
                               "config": "family_d_gray",
                               "traffic": "train-b128-k1-f32", "chips": 1,
                               "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_clips_per_s":
            m["workloads"].append("train-dg-b128")
    bench["per_layer"].append({"name": "clips_per_step.train",
                               "unit": "clips", "better": "higher",
                               "source": "program_counter",
                               "layer": "trainer dispatch",
                               "moves": "train_clips_per_s",
                               "workloads": ["train-dg-b128"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import harness\n"
        "c = harness.cell('train-dg-b128')\n"
        "assert c['config']['name'] == 'family_d_gray'\n"
        "assert c['traffic']['batch'] == 128\n"
        "assert [m['name'] for m in c['per_layer']] == "
        "['clips_per_step.train']\n"
        "assert 'train_clips_per_s' in [m['name'] for m in c['end_to_end']]\n"
        "class Ctx: traffic = c['traffic']\n"
        "r = harness.load_module('metrics', 'clips_per_step.train')\n"
        "assert r.read(Ctx, None, {}) == 128\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)
