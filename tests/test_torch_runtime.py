"""The port's Hogwild runtime against the JAX package's (tests/test_runtime.py).

The first half is host-only: counters stand in for stores, as in the
reference's tests, plus the port's own contracts (hooks hold the slot's
lock; the launch counter loses no update). The second half runs the real
stores on the CPU and holds them to the JAX package's from the same arrays:
two-phase against JAX's one-shot step and the stale apply against JAX's
tables within 2e-5, Hogwild convergence within 15% of one trainer (JAX's
rule), and the exact step counter.

Every loop runs on a helper thread joined with a timeout, so a hung runtime
fails its test instead of the whole run.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import KGEConfig as JaxCfg
from repro.core import kge_model as JK
from repro.core.step import store_train_step as jax_store_train_step
from repro.embeddings.store import DenseStore as JaxDenseStore
from repro_torch.common.config import KGEConfig
from repro_torch.core import kge_model as TK
from repro_torch.core.sampling import JointSampler
from repro_torch.core.step import store_apply_grads, store_grads, store_train_step
from repro_torch.data.kg_synth import make_synthetic_kg
from repro_torch.data.pipeline import worker_rngs
from repro_torch.embeddings.store import DenseStore
from repro_torch.kernels import build
from repro_torch.launch.engine import CheckpointHook, Hook, MetricsHook, train_loop
from repro_torch.launch.runtime import StoreSlot, hogwild_train_loop

torch.set_num_threads(2)

TIMEOUT_S = 120.0


def bounded(fn, *args, timeout=TIMEOUT_S, **kw):
    """``fn(*args, **kw)`` on a helper thread; its result, or its exception
    re-raised. Fails if it has not returned within ``timeout`` seconds."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:  # handed to the test thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"{fn.__name__} did not return within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


# ---------------------------------------------------------------------------
# host-only: slot + loop mechanics
# ---------------------------------------------------------------------------
def test_store_slot_swap_is_atomic():
    slot = StoreSlot(0)
    n_threads, n_swaps = 8, 200

    def worker():
        for _ in range(n_swaps):
            slot.swap(lambda cur: cur + 1)

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in ts)
    assert slot.read() == n_threads * n_swaps
    assert slot.version == n_threads * n_swaps


def _count_step(state, batch):
    return state + 1, {"loss": float(state)}


def _batches():
    return ({"x": 0}, None)


def test_hogwild_runs_exact_steps_whole_step():
    """Chained whole-step mode: no step lost, no step duplicated."""
    mh = MetricsHook()
    out = bounded(hogwild_train_loop, _count_step, 0, _batches, 50, hooks=[mh],
                  n_trainers=4, n_samplers=2, sampler_factory=lambda wid: _batches)
    assert out == 50
    assert len(mh.history["loss"]) == 50


def test_hogwild_runs_exact_steps_two_phase():
    """Two-phase mode: apply lands on the LATEST state -> no lost updates."""
    grad = lambda s, b: (1, {"loss": 0.0})  # noqa: E731
    apply = lambda s, b, g: s + g  # noqa: E731
    out = bounded(hogwild_train_loop, None, 0, _batches, 60, n_trainers=4,
                  split_step=(grad, apply))
    assert out == 60


def test_hogwild_hook_steps_are_monotone():
    seen = []

    class Recorder(Hook):
        def on_step(self, i, state, metrics, stats):
            seen.append(i)

    bounded(hogwild_train_loop, _count_step, 0, _batches, 30, hooks=[Recorder()],
            n_trainers=3)
    assert seen == list(range(1, 31))


def test_hogwild_honors_start_and_fully_trained_resume():
    out = bounded(hogwild_train_loop, _count_step, 3, _batches, 5, start=3,
                  n_trainers=2)
    assert out == 5  # 3 + 2 steps
    mh = MetricsHook()
    out = bounded(hogwild_train_loop, _count_step, 7, _batches, 5, start=7,
                  hooks=[mh], n_trainers=2)
    assert out == 7 and mh.history["loss"] == []


def test_hogwild_stats_carry_trainer_and_queue_depth():
    stats_seen = []

    class Recorder(Hook):
        def on_step(self, i, state, metrics, stats):
            stats_seen.append(stats)

    bounded(hogwild_train_loop, _count_step, 0, _batches, 20, hooks=[Recorder()],
            n_trainers=2)
    assert len(stats_seen) == 20
    assert all("trainer" in s and "queue_depth" in s for s in stats_seen)


def test_hogwild_error_propagates_without_hanging():
    def bad_step(state, batch):
        if state >= 5:
            raise RuntimeError("boom")
        return state + 1, {"loss": 0.0}

    with pytest.raises(RuntimeError, match="boom"):
        bounded(hogwild_train_loop, bad_step, 0, _batches, 1000, n_trainers=3,
                n_samplers=2, sampler_factory=lambda wid: _batches)


def test_hogwild_requires_factory_for_multiple_samplers():
    with pytest.raises(ValueError, match="sampler_factory"):
        hogwild_train_loop(_count_step, 0, _batches, 5, n_samplers=2)


def test_hogwild_checkpoint_hook_sees_monotone_consistent_saves(tmp_path):
    saves = []
    hook = CheckpointHook(str(tmp_path), save_every=5,
                          save_fn=lambda d, i, s: saves.append((i, s)))
    out = bounded(train_loop, _count_step, 0, _batches, 20, hooks=[hook],
                  n_trainers=3)
    assert out == 20
    assert [i for i, _ in saves] == [5, 10, 15, 20]  # final covered by 20
    # every saved state is a real snapshot: at least i steps were applied
    assert all(s >= i for i, s in saves)


def test_hooks_hold_the_slot_lock_against_applies():
    """The port's barrier: no apply runs while a hook runs, so a hook that
    reads the (in-place) tables sees no step half applied."""
    in_hook = threading.Event()
    overlaps = []

    class Slow(Hook):
        def on_step(self, i, state, metrics, stats):
            in_hook.set()
            threading.Event().wait(0.001)
            in_hook.clear()

    def grad(s, b):  # gives up the GIL, so other trainers reach their hooks
        threading.Event().wait(0.001)
        return 0, {"loss": 0.0}

    def apply(s, b, g):
        overlaps.append(in_hook.is_set())
        return s + 1

    out = bounded(train_loop, None, 0, _batches, 40, hooks=[Slow()], n_trainers=4,
                  split_step=(grad, apply))
    assert out == 40 and len(overlaps) == 40 and not any(overlaps)


def test_ordered_steps_run_in_batch_order_with_their_hooks():
    """Ordered mode, 3 trainers and 3 samplers: step t takes sampler
    ``t mod 3``'s next batch, steps apply in that order (each step sees
    the state of all earlier ones), and hook i sees batch i - 1 - start,
    whatever thread stepped it. The interpreter switches threads often."""
    seen, applied = [], []

    def factory(wid):
        counter = iter(range(10_000))
        return lambda: ((wid, next(counter)), None)

    def step(state, batch):
        applied.append((state, batch))
        return state + 1, {"loss": 0.0}

    class Recorder(Hook):
        def on_step(self, i, state, metrics, stats):
            seen.append((i, state, stats["trainer"]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = bounded(hogwild_train_loop, step, 4, None, 40, start=4,
                      hooks=[Recorder()], n_trainers=3, n_samplers=3,
                      sampler_factory=factory, ordered=True)
    finally:
        sys.setswitchinterval(interval)
    batches = [(t % 3, t // 3) for t in range(36)]
    assert out == 40
    assert applied == [(4 + t, b) for t, b in enumerate(batches)]
    assert [(i, s) for i, s, _ in seen] == [(5 + t, 5 + t) for t in range(36)]
    assert seen[0][2] == 0 and {tr for _, _, tr in seen} <= {0, 1, 2}


def test_ordered_failed_step_stops_the_waiting_trainers():
    """A step that raises in ordered mode re-raises in the caller; the
    trainers holding later batches stop at the turnstile, and no later
    step runs."""
    ran = []

    def step(state, batch):
        if batch == 5:
            raise RuntimeError("boom")
        ran.append(batch)
        return state + 1, {}

    counter = iter(range(10_000))
    with pytest.raises(RuntimeError, match="boom"):
        bounded(hogwild_train_loop, step, 0, lambda: (next(counter), None), 50,
                n_trainers=4, ordered=True)
    assert ran == [0, 1, 2, 3, 4]


def test_ordered_mode_refuses_a_split_step():
    with pytest.raises(ValueError, match="whole-step swap"):
        hogwild_train_loop(_count_step, 0, _batches, 5, n_trainers=2, ordered=True,
                           split_step=(lambda s, b: (1, {}), lambda s, b, g: s))


def test_launch_counter_loses_no_update_under_contention():
    """``build.count`` from more threads than cores, switching often: the
    total is exact (a bare ``+= 1`` can lose increments here)."""
    n_threads, n_incs = 16, 2000
    old = sys.getswitchinterval()
    build.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [build.count("fused_update", "dedup_aggregate")
                                               for _ in range(n_incs)])
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(TIMEOUT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert build.LAUNCHES["fused_update"] == n_threads * n_incs
    assert build.LAUNCHES["dedup_aggregate"] == n_threads * n_incs
    build.reset_launches()


# ---------------------------------------------------------------------------
# real stores: two-phase == one-shot, staleness contract, convergence
# ---------------------------------------------------------------------------
_TINY = dict(model="transe_l2", n_entities=50, n_relations=7, dim=8, batch_size=6,
             neg_sample_size=4, lr=0.1, n_parts=1)


def _tiny_arrays(cfg, seed=0):
    key = jax.random.key(seed)
    ent = np.asarray(jax.random.normal(key, (cfg.n_entities, cfg.dim)) * 0.1)
    rel = np.asarray(jax.random.normal(key, (cfg.n_relations, cfg.rel_dim)) * 0.1)
    return ent, rel


def _jax_stores(cfg, ent, rel):
    return {"entity": JaxDenseStore.create(jnp.asarray(ent), lr=cfg.lr),
            "rel": JaxDenseStore.create(jnp.asarray(rel), lr=cfg.lr)}


def _torch_stores(cfg, ent, rel):
    return {"entity": DenseStore.create(torch.from_numpy(ent.copy()), lr=cfg.lr),
            "rel": DenseStore.create(torch.from_numpy(rel.copy()), lr=cfg.lr)}


def _ids(cfg, seed):
    rng = np.random.default_rng(seed)
    b, k, ng = cfg.batch_size, cfg.neg_sample_size, cfg.n_neg_groups
    return {"h": rng.integers(0, cfg.n_entities, b),
            "t": rng.integers(0, cfg.n_entities, b),
            "r": rng.integers(0, cfg.n_relations, b),
            "neg": rng.integers(0, cfg.n_entities, (2, ng, k))}


def _jax_batch(ids):
    return JK.dense_step_batch({k: jnp.asarray(v, jnp.int32) for k, v in ids.items()})


def _torch_batch(ids):
    return TK.dense_step_batch({k: torch.from_numpy(v) for k, v in ids.items()})


def _tables(stores):
    return {name: (s.table.clone(), s.gsq.clone()) for name, s in stores.items()}


def test_two_phase_equals_one_shot_step_and_jax():
    """store_grads + store_apply_grads is store_train_step bit for bit, and
    both are JAX's one-shot step within 2e-5 from the same arrays."""
    jc, tc = JaxCfg(**_TINY), KGEConfig(**_TINY)
    ent, rel = _tiny_arrays(tc)
    ids = _ids(tc, 0)
    want, m_jax = jax_store_train_step(jc, _jax_stores(jc, ent, rel), _jax_batch(ids))

    one_shot, m1 = store_train_step(tc, _torch_stores(tc, ent, rel), _torch_batch(ids))
    stores = _torch_stores(tc, ent, rel)
    grads, m2 = store_grads(tc, stores, _torch_batch(ids))
    two_phase = store_apply_grads(stores, _torch_batch(ids), grads)

    assert float(m1["loss"]) == float(m2["loss"])
    np.testing.assert_allclose(float(m2["loss"]), float(m_jax["loss"]), rtol=2e-5)
    for name in ("entity", "rel"):
        assert torch.equal(one_shot[name].table, two_phase[name].table)
        assert torch.equal(one_shot[name].gsq, two_phase[name].gsq)
        np.testing.assert_allclose(two_phase[name].table.numpy(),
                                   np.asarray(want[name].table), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(two_phase[name].gsq.numpy(),
                                   np.asarray(want[name].gsq), rtol=2e-5, atol=2e-5)


def test_staleness_contract_no_lost_updates_matches_jax():
    """Trainers A and B both read s0; A applies, then B's stale gradient
    lands on the latest tables. Rows only A touched keep A's update, rows
    only B touched move, and the tables equal JAX's s2 within 2e-5."""
    jc, tc = JaxCfg(**_TINY), KGEConfig(**_TINY)
    ent, rel = _tiny_arrays(tc)
    ids_a, ids_b = _ids(tc, 1), _ids(tc, 2)

    # the reference: immutable stores
    j0 = _jax_stores(jc, ent, rel)
    from repro.core.step import store_apply_grads as j_apply, store_grads as j_grads

    ga, _ = j_grads(jc, j0, _jax_batch(ids_a))
    j1 = j_apply(j0, _jax_batch(ids_a), ga)
    gb, _ = j_grads(jc, j0, _jax_batch(ids_b))
    j2 = j_apply(j1, _jax_batch(ids_b), gb)

    # the port: in place, so both gradients are taken before either apply
    s = _torch_stores(tc, ent, rel)
    batch_a, batch_b = _torch_batch(ids_a), _torch_batch(ids_b)
    grads_a, _ = store_grads(tc, s, batch_a)
    grads_b, _ = store_grads(tc, s, batch_b)
    t0 = s["entity"].table.clone()
    store_apply_grads(s, batch_a, grads_a)
    t1 = s["entity"].table.clone()
    store_apply_grads(s, batch_b, grads_b)
    t2 = s["entity"].table

    a_rows = set(batch_a["ent_ids"].tolist())
    b_rows = set(batch_b["ent_ids"].tolist())
    only_a, only_b = sorted(a_rows - b_rows), sorted(b_rows - a_rows)
    assert only_a and only_b, "fixture must have rows unique to A and to B"
    assert torch.equal(t2[only_a], t1[only_a])
    assert not torch.equal(t1[only_a], t0[only_a])
    assert not torch.equal(t2[only_b], t1[only_b])
    for name in ("entity", "rel"):
        np.testing.assert_allclose(s[name].table.numpy(), np.asarray(j2[name].table),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(s[name].gsq.numpy(), np.asarray(j2[name].gsq),
                                   rtol=2e-5, atol=2e-5)


def _jax_state_arrays(cfg_kw, seed=0):
    js = JK.init_state(JaxCfg(**cfg_kw), jax.random.key(seed))
    return {"entity": np.asarray(js.entity), "r_emb": np.asarray(js.r_emb)}


def test_hogwild_matches_single_trainer_convergence():
    """A 4-trainer Hogwild run reaches the single-trainer loss (JAX's rule:
    the means of the last 30 losses within 15%), from JAX's tables."""
    kg = make_synthetic_kg(n_entities=2000, n_relations=40, n_edges=40_000,
                           n_clusters=8, seed=0)
    kw = dict(model="transe_l2", n_entities=kg.n_entities, n_relations=kg.n_relations,
              dim=32, gamma=10.0, batch_size=256, neg_sample_size=64,
              neg_deg_ratio=0.5, lr=0.25, n_parts=1)
    cfg = KGEConfig(**kw)
    arrays = _jax_state_arrays(kw)
    steps = 200

    def run(n_trainers, n_samplers):
        samplers = [JointSampler(kg.train, cfg.n_entities, cfg, r)
                    for r in worker_rngs(0, n_samplers)]

        def factory(wid):
            s = samplers[wid]
            return lambda: (TK.batch_to_device(s.sample(), "cpu"), None)

        mh = MetricsHook()
        state = bounded(
            train_loop, lambda st, b: TK.train_step(cfg, st, b),
            TK.state_from_arrays(cfg, arrays, device="cpu"), factory(0), steps,
            hooks=[mh], n_trainers=n_trainers, n_samplers=n_samplers,
            sampler_factory=factory,
            split_step=TK.make_hogwild_step(cfg) if n_trainers > 1 else None)
        assert state.step == steps
        losses = mh.history["loss"]
        assert len(losses) == steps
        return losses

    base = run(1, 1)
    hog = run(4, 2)
    base_final = float(np.mean(base[-30:]))
    hog_final = float(np.mean(hog[-30:]))
    assert base_final < base[0] / 3
    assert hog_final < hog[0] / 3
    assert abs(hog_final - base_final) / base_final < 0.15


def test_hogwild_final_state_step_counter_counts_all_applies():
    kg = make_synthetic_kg(n_entities=300, n_relations=10, n_edges=4000,
                           n_clusters=4, seed=0)
    kw = dict(model="transe_l2", n_entities=kg.n_entities, n_relations=kg.n_relations,
              dim=8, batch_size=32, neg_sample_size=8, lr=0.1, n_parts=1)
    cfg = KGEConfig(**kw)
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(0))
    state = bounded(
        train_loop, lambda st, b: TK.train_step(cfg, st, b),
        TK.state_from_arrays(cfg, _jax_state_arrays(kw), device="cpu"),
        lambda: (TK.batch_to_device(sampler.sample(), "cpu"), None), 25,
        n_trainers=3, split_step=TK.make_hogwild_step(cfg))
    assert state.step == 25
    assert bool(torch.isfinite(state.entity).all())
