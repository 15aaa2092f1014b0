"""The check that decides ``correct``: the reference agrees with the port at
a tiny size on the CPU, and a run with the timed path broken underneath
(its state left unchanged; half of each batch left out; the deferred entity
update's flush left out) comes out not correct."""

import pytest

from _tiny import cells, tiny  # puts the repo root and src/ on sys.path

import torch

from kgebench import graph, harness

torch.set_num_threads(2)
CELLS = cells()


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(graph, "CACHE_DIR", tmp_path / "cache")


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    cell = tiny(harness.load_cell(name))
    train = harness.graph_train(cell)
    cpu = torch.device("cpu")
    for seed in (0, 2**31 + 11):
        prog = harness.Program(cell.spec, train, seed, cpu)
        check = harness.CheckHook(prog, cell.workload["check_steps"])
        prog.loop(cell.workload["check_steps"], hooks=[check])
        got = check.readings()
        want, batches = harness.reference_readings(cell, train, seed, cpu)
        assert harness.batch_id_diff(prog.batches, batches) == 0
        gaps = harness.compare(got, want)
        assert max(gaps.values()) < 1e-5, gaps
        # a table the score never reads (RESCAL's relation rows) has a
        # gradient of 0 and may keep its values
        assert all(v > 0 for k, v in got["change_norms"].items()
                   if want["grad_norms"][k] > 0)


def _run(name):
    cell = tiny(harness.load_cell(name))
    return harness.run_cell(cell, 7, 0.1, False, torch.device("cpu"), 0.0,
                            window_steps=4)


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_profiles_the_steps_after_the_window(name, monkeypatch):
    """``step_device_ms``, an end-to-end metric, comes in every run from the
    cell's traced steps after the window, profiled; a --trace 0 line still
    carries no trace of its own."""
    from kgebench import trace as T

    seen = []

    def spy(prof, steps, window_s, _orig=T.from_profiler):
        seen.append((steps, window_s))
        return _orig(prof, steps, window_s)

    monkeypatch.setattr(T, "from_profiler", spy)
    out = _run(name)
    assert len(seen) == 1 and seen[0][0] == tiny(harness.load_cell(name)).workload["traced_steps"]
    assert seen[0][1] > 0
    assert out["attempted"] == 3 and "busy_s" not in out["device"] and "breakdown" not in out


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    import repro_torch.embeddings.store as store

    monkeypatch.setattr(store, "sparse_adagrad_apply",
                        lambda table, gsq, ids, grads, lr, eps=1e-10: (table, gsq))
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["param_change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    from repro_torch.core import kge_model

    lower = kge_model.dense_step_batch

    def half(batch):
        out = lower(batch)
        b = out["h_slot"].shape[0] // 2
        return dict(out, h_slot=out["h_slot"][:b], t_slot=out["t_slot"][:b],
                    rel_slot=out["rel_slot"][:b])

    monkeypatch.setattr(kge_model, "dense_step_batch", half)
    out = _run(name)
    assert not out["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_flush_left_out_is_not_correct(name, monkeypatch):
    from repro_torch.core import kge_model

    monkeypatch.setattr(kge_model, "flush_state", lambda cfg, state: state)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["param_change"]["value"] > 1e-3


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(name):
    """The reference with its products in TF32, in the program's place."""
    cell = tiny(harness.load_cell(name))
    train = harness.graph_train(cell)
    cpu = torch.device("cpu")
    want, batches = harness.reference_readings(cell, train, 3, cpu)
    got, _ = harness.reference_readings(cell, train, 3, cpu, tf32=True)
    correct, checks = harness.judge(got, want, batches, batches, 0,
                                    cell.workload["limits"])
    assert not correct, checks


def test_round_tf32_keeps_ten_mantissa_bits_ties_to_even():
    from kgebench.reference.precision import round_tf32

    u = 2.0 ** -10  # TF32's step at 1
    x = torch.tensor([1 + u / 2, 1 + 3 * u / 2, 1 + u / 4, 1 + u, -(1 + 3 * u / 4), 3.0])
    want = torch.tensor([1.0, 1 + 2 * u, 1.0, 1 + u, -(1 + u), 3.0])
    assert torch.equal(round_tf32(x), want)
