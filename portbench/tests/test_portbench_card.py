"""One short run of the first cell on the card (marker ``cuda``):
``python -m pytest -m cuda portbench/tests/test_portbench_card.py``."""

import json

import pytest
import torch

from portbench import run

pytestmark = pytest.mark.cuda


def test_first_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    bench = json.loads(run.BENCHMARK.read_text())
    cell = bench["workloads"][0]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    out = run.run_cell(cell, run.load_json(run.HERE.parent / cfg["file"]),
                       run.load_json(run.HERE / "traffic"
                                     / f"{cell['traffic']}.json"),
                       2**31 + 99, 3.0, False, bench)
    assert out["correct"] and out["failed"] == 0
