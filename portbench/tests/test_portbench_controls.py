"""The control of each cell on the card, at the cell's own size: the
reference in the program's place in the precision below the cell's (TF32
for float32 with TF32 off, float8 for bfloat16) fails the cell's limits,
and so does each fault (half a batch left out, the state left unchanged),
as ``python3 portbench/controls.py`` reads them (`PERF.md`)."""

import pytest
import torch

from portbench import controls, harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train-d-b256", "train-a-b4-k4",
                                  "train-d-b256-bf16-k4", "serve-a-cameras"])
def test_control_and_faults_fail(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = harness.cell(name)
    for seed in (101, 102, 103):
        got = controls.readings(cell, seed, torch.device("cuda"))
        for reading in got.values():
            assert not harness.passes(reading, cell["limits"]), (seed, got)
