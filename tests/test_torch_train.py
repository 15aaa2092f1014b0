"""The slice: single-machine joint-negative training, port vs JAX package.

Both packages start from the JAX-initialised tables (carried across with
``state_from_arrays``) and step through the same JointSampler stream. The
loss trajectory and the final tables and accumulators must match.

Rule for the tables (Adagrad's first step is lr * g / (|g| + 1e-10), about
+-lr for ANY g != 0, so an entry whose gradient is near zero may flip by
2 lr between two correct implementations that sum in other orders): every
entry within rtol = atol = 1e-5, except at most 0.1% of the entries, and
those by no more than 2 * lr * steps. The losses match within 2e-5.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.common.config import KGEConfig as JaxCfg
from repro.core import kge_model as JK
from repro.core.sampling import JointSampler as JaxJointSampler
from repro.core.sampling import NaiveSampler as JaxNaiveSampler
from repro.data.kg_synth import make_synthetic_kg
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import kge_model as TK
from repro_torch.core.sampling import JointSampler, NaiveSampler
from repro_torch.kernels import build
from repro_torch.launch import engine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 5
N_ENT, N_REL = 300, 12


@pytest.fixture(scope="module")
def kg():
    return make_synthetic_kg(n_entities=N_ENT, n_relations=N_REL, n_edges=3000,
                             n_clusters=4, seed=0)


def _cfgs(model, **over):
    kw = dict(model=model, n_entities=N_ENT, n_relations=N_REL, dim=32,
              batch_size=32, neg_sample_size=8, neg_group_size=16, gamma=12.0,
              lr=0.1)
    kw.update(over)
    return JaxCfg(**kw), TorchCfg(**kw)


def _jax_arrays(state):
    return {f.name: (None if getattr(state, f.name) is None
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def assert_tables_close(got, want, lr, steps, name):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    off = diff > 1e-5 + 1e-5 * np.abs(want)
    assert off.mean() <= 1e-3, f"{name}: {off.sum()} of {off.size} entries off"
    assert diff.max() <= 2 * lr * steps, f"{name}: max diff {diff.max()}"


@pytest.mark.parametrize("overlap", [True, False], ids=["t5", "no_t5"])
@pytest.mark.parametrize("model", ["transe_l2", "distmult", "complex", "transe_l1",
                                   "rotate", "transr", "rescal"])
def test_slice_matches_jax(kg, model, overlap):
    jc, tc = _cfgs(model)
    js = JK.init_state(jc, jax.random.key(0), overlap=overlap)
    ts = TK.state_from_arrays(tc, _jax_arrays(js), device="cpu")
    assert (ts.pend_ids is not None) == overlap
    sj = JaxJointSampler(kg.train, N_ENT, jc, np.random.default_rng(1))
    st = JointSampler(kg.train, N_ENT, tc, np.random.default_rng(1))
    lj, lt = [], []
    for _ in range(STEPS):
        js, mj = JK.train_step(jc, js, JK.batch_to_device(sj.sample()))
        ts, mt = TK.train_step(tc, ts, TK.batch_to_device(st.sample(), "cpu"))
        lj.append(float(mj["loss"]))
        lt.append(float(mt["loss"]))
        if overlap:
            assert float(mt["pend_dropped"]) == 0
    np.testing.assert_allclose(lt, lj, rtol=2e-5, atol=2e-5)
    js, ts = JK.flush_state(jc, js), TK.flush_state(tc, ts)
    got = TK.state_to_arrays(ts)
    want = _jax_arrays(js)
    assert got["step"] == want["step"] == STEPS
    for name in ("entity", "ent_gsq", "r_emb", "rel_gsq", "r_proj", "proj_gsq"):
        assert (got[name] is None) == (want[name] is None), name
        if want[name] is not None:
            assert_tables_close(got[name], want[name], tc.lr, STEPS, name)
    if overlap:
        np.testing.assert_array_equal(got["pend_ids"], want["pend_ids"])


def test_naive_step_matches_jax(kg):
    jc, tc = _cfgs("transe_l2", neg_group_size=0, batch_size=16)
    js = JK.init_state(jc, jax.random.key(1))
    ts = TK.state_from_arrays(tc, _jax_arrays(js), device="cpu")
    sj = JaxNaiveSampler(kg.train, N_ENT, jc, np.random.default_rng(2))
    st = NaiveSampler(kg.train, N_ENT, tc, np.random.default_rng(2))
    for _ in range(2):
        js, mj = JK.naive_train_step(jc, js, JK.batch_to_device(sj.sample()))
        ts, mt = TK.naive_train_step(tc, ts, TK.batch_to_device(st.sample(), "cpu"))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=2e-5)
    assert_tables_close(ts.entity.numpy(), np.asarray(js.entity), tc.lr, 2, "entity")


def test_state_arrays_round_trip_and_checks():
    _, tc = _cfgs("transr", rel_dim=4)
    st = TK.init_state(tc, torch.Generator().manual_seed(3), overlap=True, device="cpu")
    assert st.r_proj.shape == (N_REL, 32 * 4)
    arrays = TK.state_to_arrays(st)
    assert arrays["pend_ids"].dtype == np.int32
    back = TK.state_from_arrays(tc, arrays, device="cpu")
    for name in TK.ARRAY_FIELDS:
        a, b = TK.state_to_arrays(back)[name], arrays[name]
        np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(ValueError, match="entity"):
        TK.state_from_arrays(tc, dict(arrays, entity=np.zeros((2, 2), np.float32)),
                             device="cpu")


def test_train_loop_hooks_and_no_gpu_refusal(kg):
    _, tc = _cfgs("transe_l2")
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TK.init_state(tc)
    st = TK.init_state(tc, overlap=True, device="cpu")
    sampler = JointSampler(kg.train, N_ENT, tc, np.random.default_rng(0))
    hook = engine.MetricsHook(("loss", "pend_dropped", "absent"))
    lines = []
    st = engine.train_loop(
        lambda s, b: TK.train_step(tc, s, b), st,
        lambda: (TK.batch_to_device(sampler.sample(), "cpu"), None), 6,
        hooks=[engine.LoggingHook(3, batch_size=32, print_fn=lines.append), hook])
    assert st.step == 6 and len(lines) == 2 and lines[-1].startswith("step      6")
    h = hook.history
    assert len(h["loss"]) == 6 and all(np.isfinite(h["loss"]))
    assert h["pend_dropped"] == [0.0] * 6 and all(np.isnan(h["absent"]))


def _run_cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_cli_runs_on_cpu_and_refuses_without_gpu():
    out = _run_cli(["--device", "cpu", "--steps", "3", "--scale", "0.02",
                    "--dim", "16", "--batch-size", "32", "--neg", "8",
                    "--log-every", "3"])
    assert out.returncode == 0, out.stderr
    assert "step      3 loss" in out.stdout
    if not torch.cuda.is_available():
        out = _run_cli(["--steps", "1", "--scale", "0.02"])
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr


def test_cli_trains_rescal_and_leaves_its_relation_rows():
    """RESCAL's score reads only the projection rows, so the relation rows
    get a zero gradient (as from JAX's value_and_grad): the step takes it,
    and Adagrad leaves the relation table and its accumulator as they were."""
    from repro_torch.launch import train

    hook = engine.MetricsHook(("loss",))
    cfg, st = train.main(["--device", "cpu", "--model", "rescal", "--steps", "3",
                          "--scale", "0.02", "--dim", "16", "--batch-size", "32",
                          "--neg", "8", "--log-every", "3"], hooks=[hook])
    fresh = TK.init_state(cfg, torch.Generator().manual_seed(0), overlap=True,
                          device="cpu")
    TK.flush_state(cfg, st)
    assert st.step == 3 and all(np.isfinite(hook.history["loss"]))
    assert torch.equal(st.r_emb, fresh.r_emb) and torch.equal(st.rel_gsq, fresh.rel_gsq)
    assert not torch.equal(st.r_proj, fresh.r_proj)
    assert not torch.equal(st.entity, fresh.entity)


def test_cli_refuses_unported_modes():
    """The pipelined flags are refused where JAX refuses them: without
    --distributed (an argparse error, exit 2) and with more than one
    trainer or sampler (JAX's SystemExit). --trainers/--samplers with
    --distributed, refused until the ordered runtime ported them, train."""
    from repro_torch.launch import train

    for flags in (["--push-every", "2"], ["--pipeline-depth", "1"]):
        with pytest.raises(SystemExit) as err:
            train.main(["--device", "cpu", *flags])
        assert err.value.code == 2
    with pytest.raises(SystemExit, match="incompatible with --trainers/--samplers"):
        train.main(["--device", "cpu", "--distributed", "--push-every", "2",
                    "--samplers", "2"])
    for flags in (["--trainers", "2"], ["--samplers", "2"]):
        cfg, final = train.main(["--device", "cpu", "--distributed", "--mesh", "1x1",
                                 "--steps", "3", "--scale", "0.02", "--dim", "16",
                                 "--batch-size", "32", "--neg", "8", *flags])
        assert final["step"] == 3 and np.isfinite(final["entity"]).all()
    # the port's kernels are chosen by the tensors' device: --use-kernel
    # trains on cuda and is refused on the CPU, where nothing launches them
    with pytest.raises(ValueError, match="--use-kernel"):
        train.main(["--device", "cpu", "--use-kernel"])


def test_cli_hogwild_trains_exact_steps_and_writes_valid_files(tmp_path):
    """``--trainers 2 --samplers 2 --metrics-out --trace-out`` on the CPU:
    exactly --steps applies (the state's counter and both step counters),
    T5 off, and files that pass the validators of both packages."""
    from repro.common import telemetry as jax_telemetry
    from repro_torch.common import telemetry
    from repro_torch.launch import train

    m, t = tmp_path / "m.jsonl", tmp_path / "t.json"
    hook = engine.MetricsHook(("loss",))
    cfg, st = train.main(["--device", "cpu", "--trainers", "2", "--samplers", "2",
                          "--steps", "12", "--scale", "0.02", "--dim", "16",
                          "--batch-size", "32", "--neg", "8", "--log-every", "5",
                          "--metrics-out", str(m), "--trace-out", str(t)],
                         hooks=[hook])
    assert st.step == 12 and st.pend_ids is None
    assert len(hook.history["loss"]) == 12 and all(np.isfinite(hook.history["loss"]))
    assert not telemetry.get_registry().enabled  # the run's registry is gone
    for mod in (telemetry, jax_telemetry):
        assert mod.validate_metrics_jsonl(str(m), require=("engine/steps",
                                                           "runtime/steps")) == 3
        assert mod.validate_trace(str(t)) > 0
    last = [json.loads(line) for line in m.read_text().splitlines()][-1]
    assert last["step"] == 12
    assert last["counters"]["engine/steps"] == last["counters"]["runtime/steps"] == 12
    tracks = {e["args"]["name"] for e in json.loads(t.read_text())["traceEvents"]
              if e.get("ph") == "M"}
    assert {"trainer-0", "trainer-1"} <= tracks


def test_telemetry_counts_flushes_and_records_spans(kg):
    from repro_torch.common import telemetry

    _, tc = _cfgs("transe_l2")
    st = TK.init_state(tc, overlap=True, device="cpu")
    sampler = JointSampler(kg.train, N_ENT, tc, np.random.default_rng(0))
    reg = telemetry.enable(trace=True)
    try:
        for _ in range(3):
            st, _ = TK.train_step(tc, st, TK.batch_to_device(sampler.sample(), "cpu"))
        snap = telemetry.snapshot(step=3)
    finally:
        telemetry.disable()
    assert snap["step"] == 3 and snap["counters"]["store/flush_calls"] == 3
    names = [e["name"] for e in reg.trace_json()["traceEvents"]]
    assert names.count("step/grad") == 3 and names.count("step/flush") == 3
    assert not telemetry.get_registry().enabled


def test_cpu_path_launches_no_kernel(kg):
    build.reset_launches()
    _, tc = _cfgs("transe_l2")
    st = TK.init_state(tc, overlap=True, device="cpu")
    sampler = JointSampler(kg.train, N_ENT, tc, np.random.default_rng(0))
    TK.train_step(tc, st, TK.batch_to_device(sampler.sample(), "cpu"))
    assert set(build.LAUNCHES.values()) == {0}
