"""The control and a planted fault on the card, at each cell's own graph,
widths and batch, through the check that decides ``correct``: the reference
with its products in TF32 (the precision below the configurations'
float32), and the reference with half of each batch left out, each in the
program's place, come out not correct under the cell's limits."""

import gc

import pytest

from _tiny import cells  # puts the repo root and src/ on sys.path

import torch

from kgebench import graph, harness

CELLS = cells()
CONTROLS = {"tf32": {"tf32": True}, "half_batch": {"fault": "half_batch"}}


@pytest.fixture
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(graph, "CACHE_DIR", tmp_path / "cache")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_programs_place_is_not_correct(name, control, card):
    cell = harness.load_cell(name)
    harness.set_precision(cell.config)
    train = harness.graph_train(cell)
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        want, batches = harness.reference_readings(cell, train, seed, card)
        got, got_batches = harness.reference_readings(cell, train, seed, card,
                                                      **CONTROLS[control])
        correct, checks = harness.judge(got, want, got_batches, batches, 0,
                                        cell.workload["limits"])
        assert not correct, (seed, checks)
        del want, got
        gc.collect()
        torch.cuda.empty_cache()
