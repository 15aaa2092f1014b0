"""Pipelined KVStore I/O (--pipeline-depth 1, --push-every K), port vs JAX.

The twin of tests/test_pipeline_step.py. JAX's ``build_pipelined_dist_step``
on a ``make_mesh((M, S))`` of host devices and the port's gloo worlds of
``M * S`` processes start from the same global state (JAX's
``init_dist_state``, ``pf_*`` and ``co_*`` included, carried across with
``dist_state_from_arrays``) and step the same ``DistSampler`` batches, then
``finalize``. Every step's metrics must agree within 2e-5, every table,
accumulator, prefetch buffer and merge buffer within 2e-4, and ``co_ids``,
``pend_ids`` and ``step`` exactly; rank 0's KVStore counters must equal
JAX's. The coalesce merge takes the reference's sort-based route, so even
an overflowing merge buffer keeps the same rows as JAX's.

One 2x2 world runs every 2x2 case (module fixture); the rank bodies live in
``_torch_dist_bodies.py``, which imports no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_bodies as bodies
from repro.common import telemetry as jax_telemetry
from repro.common.compat import set_mesh
from repro.common.config import KGEConfig as JaxCfg
from repro.core import distributed as JD
from repro.core.graph_part import partition as jax_partition
from repro.core.rel_part import relation_partition as jax_relation_partition
from repro.core.sampling import DistSampler as JaxDistSampler
from repro.data.kg_synth import fb15k_like
from repro.embeddings import store as JS
from repro.embeddings.kvstore import KVStoreSpec as JaxSpec
from repro.launch import engine as jax_engine
from repro.launch.mesh import make_mesh
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import distributed as TD
from repro_torch.core.sampling import DistBatch
from repro_torch.embeddings import store as TS
from repro_torch.embeddings.kvstore import KVStoreSpec
from repro_torch.launch import engine, train
from repro_torch.launch.mesh import run_world

torch.set_num_threads(2)

FWD = 2e-5  # metrics
TABLE = 2e-4  # tables, accumulators, prefetch and merge buffers
TIMEOUT_S = 120.0
EXACT = ("co_ids", "pend_ids", "step")
COUNTERS = ("kvstore/prefetch_rows", "kvstore/coalesced_push_rows",
            "kvstore/coalesced_push_flushes")
# (name, pipeline_depth, push_every, steps, model, config overrides)
CASES_2X2 = [
    ("depth1_k1", 1, 1, 3, "transe_l2", {}),
    ("depth0_k4", 0, 4, 5, "distmult", {}),
    ("depth1_k4", 1, 4, 6, "transe_l2", {}),  # a flush in the loop, one in finalize
    ("overflow", 1, 4, 4, "transe_l2", {"remote_capacity": 16}),
]


def _kw(kg, M, model, **over):
    kw = dict(model=model, n_entities=kg.n_entities, n_relations=kg.n_relations,
              dim=32, batch_size=32, neg_sample_size=16, neg_group_size=16,
              lr=0.1, n_parts=M, remote_capacity=64, overlap_update=False)
    kw.update(over)
    return kw


def _programs(kg, M, depth, K, model="transe_l2", **over):
    """JAX's and the port's program, with equal shapes, and the JAX batches."""
    kw = _kw(kg, M, model, **over)
    jcfg = JaxCfg(**kw)
    book = jax_partition(kg.train, jcfg.n_entities, M, method="metis")
    rp = jax_relation_partition(kg.rel_counts(), M)
    args = (book.rows_per_part, rp.slots_per_part, rp.n_shared)
    jprog = JD.make_program(jcfg, *args, pipeline_depth=depth, push_every=K)
    tprog = TD.make_program(TorchCfg(**kw), *args, pipeline_depth=depth, push_every=K)
    assert tprog.state_shapes() == {k: (sd.shape, np.dtype(sd.dtype))
                                    for k, sd in jprog.state_shapes().items()}
    assert tprog.coalesce_slots == jprog.coalesce_slots
    sampler = JaxDistSampler(kg.train, book, rp, jcfg, np.random.default_rng(0))
    return jprog, tprog, sampler


def _port_batches(batches):
    return [DistBatch(**dataclasses.asdict(db)) for db in batches]


def _jax_case(kg, M, S, depth, K, steps, model="transe_l2", **over):
    """JAX's pipelined run on a (M, S) mesh, ``steps`` steps then finalize,
    and the port's inputs for the same run: ((torch prog, initial global
    arrays, batches), (metrics, final arrays, counters))."""
    jprog, tprog, sampler = _programs(kg, M, depth, K, model, **over)
    batches = [sampler.sample() for _ in range(steps + depth)]
    init = {k: np.asarray(v) for k, v in
            JD.init_dist_state(jprog, jax.random.key(0)).items()}
    mesh = make_mesh((M, S), ("data", "model"))
    runner, state_sh, batch_sh = JD.build_pipelined_dist_step(jprog, mesh)
    dev = [{k: jax.device_put(jnp.asarray(getattr(db, k)), batch_sh[k])
            for k in batch_sh} for db in batches]
    hist = []
    with jax_telemetry.active() as reg, set_mesh(mesh):
        state = jax.device_put(init, state_sh)
        for i in range(steps):
            state, m = (runner(state, dev[i], dev[i + 1]) if depth
                        else runner(state, dev[i]))
            hist.append({k: float(v) for k, v in m.items()})
        state = runner.finalize(state)
        counters = reg.snapshot()["counters"]
    final = {k: np.asarray(v) for k, v in state.items()}
    return (tprog, init, _port_batches(batches)), (hist, final, counters)


def assert_runs_agree(got, want):
    (g_hist, g_state, g_count), (w_hist, w_state, w_count) = got, want
    assert len(g_hist) == len(w_hist)
    for gm, wm in zip(g_hist, w_hist):
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=FWD, atol=FWD, err_msg=k)
    assert set(g_state) == set(w_state)
    for k, want_arr in w_state.items():
        got_arr = g_state[k]
        assert got_arr.shape == want_arr.shape and got_arr.dtype == want_arr.dtype, k
        if k in EXACT:
            np.testing.assert_array_equal(got_arr, want_arr, err_msg=k)
        else:
            np.testing.assert_allclose(got_arr, want_arr, rtol=TABLE, atol=TABLE,
                                       err_msg=k)
    for k in COUNTERS:
        assert g_count.get(k) == w_count.get(k), k


def _emulate_entity_ws(prog, table, db):
    """Numpy oracle for the entity workspace pull of one batch: local rows
    from the machine's own block, remote slot (p, L + q*Rp + j) from peer
    q's block at row req[p, q, j]; -1 pads are zero rows."""
    Pn, rows = prog.cfg.n_parts, prog.rows_per_part
    blocks = table.reshape(Pn, rows, -1)
    local, req = np.asarray(db.ent_local_ids), np.asarray(db.ent_remote_req)
    ws = np.zeros((Pn, prog.L + Pn * prog.Rp, table.shape[-1]), np.float32)
    for p in range(Pn):
        for s, i in enumerate(local[p]):
            if i >= 0:
                ws[p, s] = blocks[p, i]
        for q in range(Pn):
            for j, r in enumerate(req[p, q]):
                if r >= 0:
                    ws[p, prog.L + q * prog.Rp + j] = blocks[q, r]
    return ws


@pytest.fixture(scope="module")
def world_2x2(small_kg):
    """Cases (a)-(d) against JAX, the staleness trace and the eager-identity
    pair, in one 2x2 gloo world."""
    jax_cases = {name: _jax_case(small_kg, 2, 2, depth, K, steps, model, **over)
                 for name, depth, K, steps, model, over in CASES_2X2}
    _, tprog, sampler = _programs(small_kg, 2, 1, 1)
    trace = (tprog, TD.init_dist_arrays(tprog, 0),
             _port_batches([sampler.sample() for _ in range(4)]))
    _, tprog, sampler = _programs(small_kg, 2, 0, 1)
    eager = (tprog, TD.init_dist_arrays(tprog, 0),
             _port_batches([sampler.sample() for _ in range(3)]))
    runs, traced, both = run_world(
        2, 2, bodies.pipeline_cases,
        ([jax_cases[c[0]][0] for c in CASES_2X2], trace, eager), timeout_s=TIMEOUT_S)
    parity = {c[0]: (run, jax_cases[c[0]]) for c, run in zip(CASES_2X2, runs)}
    return parity, (trace, traced), both


@pytest.mark.parametrize("case", [c[0] for c in CASES_2X2])
def test_pipelined_step_matches_jax_2x2(world_2x2, case):
    got, (inputs, want) = world_2x2[0][case]
    assert_runs_agree(got, want)
    prog = inputs[0]
    counters = got[2]
    flushes = counters.get("kvstore/coalesced_push_flushes", 0)
    assert flushes == (-(-len(got[0]) // prog.push_every) if prog.push_every > 1 else 0)
    assert counters.get("kvstore/coalesced_push_rows", 0) == (
        flushes * prog.cfg.n_parts * prog.coalesce_slots)
    assert (counters.get("kvstore/prefetch_rows", 0) > 0) == bool(prog.pipeline_depth)
    # finalize drained the merge buffers
    if prog.push_every > 1:
        np.testing.assert_array_equal(got[1]["co_ids"], -1)


def test_overflowing_merge_drops_the_same_rows_as_jax(world_2x2):
    """A small remote capacity overflows the merge buffers: JAX drops
    uniques, and the port drops as many, from the same rows (co_ids equal
    before each flush is implied by the tables agreeing after it)."""
    got, (_, want) = world_2x2[0]["overflow"]
    w_drop = [m["push_dropped"] for m in want[0]]
    assert max(w_drop) > 0
    assert [m["push_dropped"] for m in got[0]] == w_drop


def test_depth1_prefetch_is_exactly_one_step_stale(world_2x2):
    """The staleness contract: the double buffer after step t holds batch
    t+1's workspace gathered from the PRE-apply table of step t, never the
    post-apply one, though the port updates its tables in place."""
    (prog, init, batches), after = world_2x2[1]
    assert len(after) == len(batches) - 1
    before = init["entity"]
    for t, state in enumerate(after):
        pf = state["pf_ent_ws"]
        np.testing.assert_allclose(pf, _emulate_entity_ws(prog, before, batches[t + 1]),
                                   rtol=1e-6, atol=1e-7)
        fresh = _emulate_entity_ws(prog, state["entity"], batches[t + 1])
        assert np.abs(pf - fresh).max() > 0
        before = state["entity"]


def test_depth0_k1_is_the_eager_step_bit_for_bit(world_2x2):
    eager, pipelined = world_2x2[2]
    assert len(eager) == len(pipelined) == 3
    for a, b in zip(eager, pipelined):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pipelined_step_matches_jax_4x1(small_kg):
    """Depth 1, K 4 for 6 steps on four machines: each has three peers'
    merge buffers."""
    inputs, want = _jax_case(small_kg, 4, 1, 1, 4, 6)
    got = run_world(4, 1, bodies.pipeline_cases, ([inputs],),
                    timeout_s=TIMEOUT_S)[0][0]
    assert_runs_agree(got, want)
    assert got[2]["kvstore/coalesced_push_flushes"] == 2


def test_coalesce_merge_and_flush_match_jax():
    """``_coalesce_remote`` and ``push_flush`` of the degenerate store
    against JAX's, with buffers that overflow: the same kept ids in the
    same slots, the same drop count, the same applied table."""
    rng = np.random.default_rng(3)
    P_, ck, rp, d, rows = 2, 6, 5, 4, 40
    co_ids = np.full((P_, ck), -1, np.int32)
    co_ids[:, :4] = rng.choice(rows, (P_, 4), replace=False)
    co_grads = np.where(co_ids[..., None] >= 0,
                        rng.normal(size=(P_, ck, d)), 0).astype(np.float32)
    req = rng.integers(-1, rows, (P_, rp)).astype(np.int32)
    g = rng.normal(size=(P_, rp, d)).astype(np.float32)
    j_ids, j_grads, j_drop = JS._coalesce_remote(
        jnp.asarray(co_ids), jnp.asarray(co_grads), jnp.asarray(req), jnp.asarray(g))
    t_ids, t_grads = torch.tensor(co_ids), torch.tensor(co_grads)
    t_drop = TS._coalesce_remote(t_ids, t_grads, torch.tensor(req), torch.tensor(g))
    assert int(j_drop) > 0 and int(t_drop) == int(j_drop)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_grads.numpy(), np.asarray(j_grads), rtol=FWD, atol=FWD)

    table = rng.normal(size=(rows, d)).astype(np.float32)
    jst = JS.ShardedStore.create(jnp.asarray(table), JaxSpec(None, P_, P_ * rp), 0.1,
                                 coalesce_slots=ck)
    jst = dataclasses.replace(jst, co_ids=j_ids, co_grads=j_grads).push_flush()
    tst = TS.ShardedStore.create(torch.tensor(table), KVStoreSpec(None, P_, P_ * rp),
                                 0.1, coalesce_slots=ck)
    tst.co_ids.copy_(t_ids)
    tst.co_grads.copy_(t_grads)
    tst.push_flush()
    np.testing.assert_allclose(tst.table.numpy(), np.asarray(jst.table),
                               rtol=TABLE, atol=TABLE)
    np.testing.assert_allclose(tst.gsq.numpy(), np.asarray(jst.gsq),
                               rtol=TABLE, atol=TABLE)
    assert (tst.co_ids == -1).all() and not tst.co_grads.any()
    assert set(tst.snapshot()) == set(jst.snapshot())


def test_validation_errors_match_jax(small_kg):
    """JAX's refusals: make_program's, train_loop's two and the store's."""
    kw = _kw(small_kg, 2, "transe_l2")
    args = (100, 8, 1)
    for over, prog_kw in ((dict(), dict(pipeline_depth=2)),
                          (dict(), dict(push_every=0)),
                          (dict(model="transr", rel_dim=16), dict(pipeline_depth=1)),
                          (dict(model="rescal"), dict(pipeline_depth=1)),
                          (dict(overlap_update=True), dict(pipeline_depth=1)),
                          (dict(overlap_update=True), dict(push_every=4))):
        msgs = []
        for make, cfg_cls in ((JD.make_program, JaxCfg), (TD.make_program, TorchCfg)):
            with pytest.raises(ValueError) as err:
                make(cfg_cls(**dict(kw, **over)), *args, **prog_kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

    class Lookahead:
        lookahead = True

        def __call__(self, state, batch, next_batch):
            return state, {}

    def make_batch():
        return {}, None

    for loop in (engine.train_loop, jax_engine.train_loop):
        with pytest.raises(ValueError, match="mutually exclusive"):
            loop(Lookahead(), None, make_batch, 2, n_trainers=2)
        with pytest.raises(ValueError, match="requires prefetch=True"):
            loop(Lookahead(), None, make_batch, 2, prefetch=False)

    spec = KVStoreSpec(None, 1, 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TS.ShardedStore(torch.zeros(4, 2), torch.zeros(4, 2), torch.zeros(0),
                        torch.zeros(0, 2), spec=spec, defer=True, coalesce=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        JS.ShardedStore(jnp.zeros((4, 2)), jnp.zeros((4, 2)), jnp.zeros((0,)),
                        jnp.zeros((0, 2)), spec=JaxSpec(None, 1, 1), defer=True,
                        coalesce=True)


def test_train_loop_peeks_and_finalizes():
    """A lookahead step sees each batch and the next; finalize runs once,
    on the last state, before the hooks' on_end."""
    seen, order = [], []
    counter = iter(range(100))

    class Runner:
        lookahead = True

        def __call__(self, state, batch, next_batch):
            seen.append((batch, next_batch))
            return state + 1, {}

        def finalize(self, state):
            order.append(("finalize", state))
            return state * 10

    class End(engine.Hook):
        def on_end(self, i, state):
            order.append(("on_end", i, state))

    out = engine.train_loop(Runner(), 0, lambda: (next(counter), None), 4,
                            hooks=[End()])
    assert seen == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert order == [("finalize", 4), ("on_end", 4, 40)] and out == 40


def _cli(*extra):
    return train.main(["--device", "cpu", "--distributed", "--mesh", "2x1",
                       "--scale", "0.02", "--dim", "16", "--batch-size", "32",
                       "--neg", "8", "--log-every", "3", "--pipeline-depth", "1",
                       "--push-every", "2", *extra])


def test_cli_pipelined_checkpoint_has_jax_layout_and_resumes(tmp_path, capsys):
    """``--distributed --mesh 2x1 --pipeline-depth 1 --push-every 2`` on the
    CPU with checkpoints: T5 turns off, the checkpoint holds JAX's
    ``state_shapes()`` (prefetch and merge buffers included; the merge ids
    all pads after the step-6 flush), JAX's ``restore_checkpoint`` reads it
    back bit for bit, and ``--resume`` goes on from it."""
    from repro.common.checkpoint import restore_checkpoint as jax_restore

    ck = tmp_path / "ck"
    cfg, final = _cli("--steps", "6", "--ckpt-dir", str(ck), "--save-every", "3")
    out = capsys.readouterr().out
    assert "pipelined KVStore I/O: T5 overlap off" in out and "step      6 loss" in out
    assert final["step"] == 6 and not cfg.overlap_update

    kg = fb15k_like(scale=0.02, seed=0)
    jcfg = JaxCfg(**dataclasses.asdict(cfg))
    book = jax_partition(kg.train, jcfg.n_entities, 2, method="metis", seed=0)
    rp = jax_relation_partition(kg.rel_counts(), 2, seed=0)
    shapes = JD.make_program(jcfg, book.rows_per_part, rp.slots_per_part, rp.n_shared,
                             pipeline_depth=1, push_every=2).state_shapes()
    assert {"pf_ent_ws", "pf_rel_ws", "co_ids", "co_grads"} <= set(shapes)
    restored = jax_restore(str(ck), shapes)
    assert set(restored) == set(final) == set(shapes)
    for k, sd in shapes.items():
        assert restored[k].shape == sd.shape and restored[k].dtype == sd.dtype, k
        np.testing.assert_array_equal(np.asarray(restored[k]), final[k], err_msg=k)
    np.testing.assert_array_equal(final["co_ids"], -1)
    assert np.abs(final["pf_ent_ws"]).max() > 0

    cfg2, final2 = _cli("--steps", "9", "--ckpt-dir", str(ck), "--resume")
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step      9 loss" in out
    assert final2["step"] == 9 and np.isfinite(final2["entity"]).all()
    assert not np.array_equal(final2["entity"], final["entity"])


def test_cli_refuses_pipelining_where_jax_does(capsys):
    """Without --distributed the flags are an argparse error (exit 2), and
    with more than one trainer or sampler a SystemExit with JAX's text."""
    for flags in (["--push-every", "2"], ["--pipeline-depth", "1"]):
        with pytest.raises(SystemExit) as err:
            train.main(["--device", "cpu", *flags])
        assert err.value.code == 2
        assert "require --distributed" in capsys.readouterr().err
    with pytest.raises(SystemExit) as err:
        train.main(["--device", "cpu", "--distributed", "--pipeline-depth", "1",
                    "--trainers", "2"])
    assert str(err.value.code) == (
        "--pipeline-depth/--push-every are incompatible with --trainers/"
        "--samplers > 1 (the lookahead is single-consumer; see "
        "launch/engine.train_loop)")
