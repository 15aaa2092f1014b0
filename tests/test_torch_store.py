"""Embedding stores and the KVStore, port vs JAX package.

The twins of tests/test_store.py's protocol, n_parts == 1 parity and
ReplicatedStore cases, and of tests/test_distributed.py's two KVStore
cases. The n_parts == 1 parity is the load-bearing one: the distributed
step is the same ``store_train_step`` over a ``ShardedStore`` whose
KVStore has ``machine_axis=None``, so Dense and Sharded agreeing means the
single-machine and cluster trainers implement one algorithm; both are also
held to JAX's sharded store from JAX's tables. The KVStore cases and the
cross-machine ReplicatedStore run in one 4x1 gloo world
(``launch.mesh.run_world``; bodies in ``_torch_dist_bodies.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_bodies as bodies
from repro.common.config import KGEConfig as JaxCfg
from repro.core import kge_model as JK
from repro.core.sampling import JointSampler as JaxJointSampler
from repro.core.step import store_train_step as jax_store_train_step
from repro.embeddings import store as JS
from repro.embeddings.kvstore import KVStoreSpec as JaxSpec
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import kge_model as TK
from repro_torch.core.step import store_train_step
from repro_torch.embeddings.kvstore import KVStoreSpec
from repro_torch.embeddings.store import (
    DenseStore, EmbeddingStore, ReplicatedStore, ShardedIds, ShardedStore,
)
from repro_torch.launch.mesh import run_world

torch.set_num_threads(2)

TABLE = 2e-4


def _kw(kg):
    return dict(model="transe_l2", n_entities=kg.n_entities, n_relations=kg.n_relations,
                dim=32, batch_size=64, neg_sample_size=32, lr=0.1, n_parts=1)


def _sharded(table, lr, defer=False, pend_slots=0):
    spec = KVStoreSpec(machine_axis=None, n_parts=1, remote_capacity=1)
    return ShardedStore.create(table, spec, lr, defer=defer, pend_slots=pend_slots)


def _to_sharded_batch(db, pad):
    sb = dict(db)
    sb["ent_ids"] = ShardedIds(db["ent_ids"], pad)
    sb["rel_ids"] = ShardedIds(db["rel_ids"], pad)
    return sb


def test_stores_satisfy_protocol():
    """Every store is an EmbeddingStore; ``coalesce_slots`` makes JAX's
    merge buffers (all pads), which the snapshot carries, and a coalescing
    store refuses to defer, as JAX's does."""
    table = torch.zeros((6, 4))
    for store in (DenseStore.create(table.clone(), 0.1), _sharded(table.clone(), 0.1),
                  ReplicatedStore.create(table.clone(), 0.1)):
        assert isinstance(store, EmbeddingStore)
    co = ShardedStore.create(table, KVStoreSpec(None, 2, 2), 0.1, coalesce_slots=4)
    jco = JS.ShardedStore.create(jnp.zeros((6, 4)), JaxSpec(None, 2, 2), 0.1,
                                 coalesce_slots=4)
    assert isinstance(co, EmbeddingStore) and co.coalesce and jco.coalesce
    for name in ("co_ids", "co_grads"):
        got, want = getattr(co, name), np.asarray(getattr(jco, name))
        assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert set(co.snapshot()) == set(jco.snapshot())
    with pytest.raises(ValueError, match="mutually exclusive"):
        ShardedStore.create(table, KVStoreSpec(None, 1, 1), 0.1, defer=True,
                            coalesce_slots=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        JS.ShardedStore.create(jnp.zeros((6, 4)), JaxSpec(None, 1, 1), 0.1,
                               defer=True, coalesce_slots=4)


@pytest.mark.parametrize("defer", [False, True])
def test_sharded_matches_dense_n_parts_1(small_kg, defer):
    """Same batches through DenseStore and the degenerate ShardedStore give
    identical losses and tables (overlap on and off), and both agree with
    JAX's degenerate ShardedStore from the same JAX tables."""
    jcfg, cfg = JaxCfg(**_kw(small_kg)), TorchCfg(**_kw(small_kg))
    jstate = JK.init_state(jcfg, jax.random.key(0), overlap=defer)
    sampler = JaxJointSampler(small_kg.train, cfg.n_entities, jcfg,
                              np.random.default_rng(0))
    raw = [sampler.sample() for _ in range(3)]
    ent0 = np.asarray(jstate.entity)
    rel0 = np.asarray(jstate.r_emb)
    slots = 2 * cfg.batch_size + 2 * cfg.n_neg_groups * cfg.neg_sample_size + 1

    dstate = TK.state_from_arrays(cfg, {"entity": ent0, "r_emb": rel0}, device="cpu")
    dstores = TK.stores_from_state(cfg, dstate)
    dstores["entity"].defer = defer
    dstores["entity"].pend_ids = torch.full((slots - 1,), -1, dtype=torch.int32)
    dstores["entity"].pend_grads = torch.zeros((slots - 1, cfg.dim))
    sstores = {"entity": _sharded(torch.tensor(ent0), cfg.lr, defer, slots),
               "rel": _sharded(torch.tensor(rel0), cfg.lr)}
    jspec = JaxSpec(machine_axis=None, n_parts=1, remote_capacity=1)
    jstores = {"entity": JS.ShardedStore.create(jnp.asarray(ent0), jspec, jcfg.lr,
                                                defer=defer, pend_slots=slots),
               "rel": JS.ShardedStore.create(jnp.asarray(rel0), jspec, jcfg.lr)}
    pad = torch.full((1, 1), -1, dtype=torch.int32)
    jpad = jnp.full((1, 1), -1, jnp.int32)
    jstep = jax.jit(lambda st, b: jax_store_train_step(jcfg, st, b))
    for b in raw:
        db = TK.dense_step_batch(TK.batch_to_device(b, "cpu"))
        dstores, dm = store_train_step(cfg, dstores, db)
        sstores, sm = store_train_step(cfg, sstores, _to_sharded_batch(db, pad))
        jdb = JK.dense_step_batch(JK.batch_to_device(b))
        jsb = dict(jdb, ent_ids=JS.ShardedIds(jdb["ent_ids"], jpad),
                   rel_ids=JS.ShardedIds(jdb["rel_ids"], jpad))
        jstores, jm = jstep(jstores, jsb)
        np.testing.assert_allclose(float(sm["loss"]), float(dm["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(sm["loss"]), float(jm["loss"]),
                                   rtol=2e-5, atol=2e-5)

    dent, sent = dstores["entity"].flush(), sstores["entity"].flush()
    jent = jstores["entity"].flush()
    for got, dense, want in ((sent.table, dent.table, jent.table),
                             (sent.gsq, dent.gsq, jent.gsq),
                             (sstores["rel"].table, dstores["rel"].table,
                              jstores["rel"].table)):
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TABLE, atol=TABLE)


def test_replicated_store_adagrad_math():
    """Scatter with dup + pad ids == dense Adagrad on the aggregated grad;
    JAX's store gives the same."""
    table = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    ids = np.asarray([1, 1, 3, -1], np.int32)
    grads = np.random.default_rng(1).normal(size=(4, 4)).astype(np.float32)
    out = ReplicatedStore.create(torch.tensor(table), lr=0.5).apply_sparse_grads(
        torch.tensor(ids), torch.tensor(grads))
    jout = JS.ReplicatedStore.create(jnp.asarray(table), lr=0.5).apply_sparse_grads(
        jnp.asarray(ids), jnp.asarray(grads))

    g = np.zeros((6, 4), np.float32)
    g[1] = grads[0] + grads[1]
    g[3] = grads[2]  # id -1 dropped
    gsq = g ** 2
    expect = table - 0.5 * g / (np.sqrt(gsq) + 1e-10)
    np.testing.assert_allclose(out.table.numpy(), expect, rtol=1e-6)
    np.testing.assert_allclose(out.gsq.numpy(), gsq, rtol=1e-6)
    np.testing.assert_allclose(out.table.numpy(), np.asarray(jout.table), rtol=1e-6)
    np.testing.assert_array_equal(out.table.numpy()[[0, 2, 4, 5]], table[[0, 2, 4, 5]])


# ------------------------------------------------------------ the 4x1 world
P_, ROWS, D = 4, 8, 16


@pytest.fixture(scope="module")
def world_4x1():
    table = np.arange(P_ * ROWS * D, dtype=np.float32).reshape(P_ * ROWS, D)
    rng = np.random.default_rng(0)
    pull_req = rng.integers(0, ROWS, size=(P_, P_, 3)).astype(np.int32)
    pull_req[0, 1, 2] = -1  # a pad
    rng = np.random.default_rng(1)
    push_req = rng.integers(0, ROWS, size=(P_, P_, 2)).astype(np.int32)
    push_grads = rng.standard_normal((P_, P_ * 2, D)).astype(np.float32)
    rep_table = rng.standard_normal((6, 4)).astype(np.float32)
    rep_ids = rng.integers(-1, 6, size=(P_, 5)).astype(np.int32)
    rep_grads = rng.standard_normal((P_, 5, 4)).astype(np.float32)
    out = run_world(P_, 1, bodies.store_cases,
                    ((table, pull_req, P_, 3), (push_grads, push_req, P_, 2),
                     (rep_table, rep_ids, rep_grads, 0.5)), timeout_s=120.0)
    return dict(table=table, pull_req=pull_req, push_req=push_req,
                push_grads=push_grads, rep=(rep_table, rep_ids, rep_grads), out=out)


def test_kvstore_pull_remote_roundtrip(world_4x1):
    """Each machine requests rows from peers; the returned rows equal the
    owner's values, zeros at pads."""
    w = world_4x1
    table, req = w["table"], w["pull_req"]
    out = np.stack(w["out"][0]).reshape(P_, P_, 3, D)
    for p in range(P_):
        for peer in range(P_):
            for j in range(3):
                r = req[p, peer, j]
                want = table[peer * ROWS + r] if r >= 0 else np.zeros(D)
                np.testing.assert_array_equal(out[p, peer, j], want)


def test_kvstore_push_grads_reach_owner(world_4x1):
    """Owner p receives, from peer q at slot j, the gradient q computed for
    workspace slot (p, j) with id req[q, p, j]."""
    w = world_4x1
    req, grads = w["push_req"], w["push_grads"]
    ids, gr = (np.stack(x) for x in w["out"][1])
    for p in range(P_):
        for q in range(P_):
            for j in range(2):
                assert ids[p, q * 2 + j] == req[q, p, j]
                np.testing.assert_array_equal(gr[p, q * 2 + j], grads[q, p * 2 + j])


def test_replicated_store_sums_over_machines(world_4x1):
    """Every replica takes the dense Adagrad step of the gradient summed
    over the machines (pads dropped), so all four stay identical."""
    table, ids, grads = world_4x1["rep"]
    g = np.zeros_like(table)
    for m in range(P_):
        for i, row in zip(ids[m], grads[m]):
            if i >= 0:
                g[i] += row
    gsq = g ** 2
    expect = table - 0.5 * g / (np.sqrt(gsq) + 1e-10)
    tables, gsqs = world_4x1["out"][2]
    for t, s in zip(tables, gsqs):
        np.testing.assert_allclose(t, expect, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(s, gsq, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(t, tables[0])
