"""The distributed step (core/distributed.py), port vs JAX package.

JAX's ``build_dist_train_step`` on a ``make_mesh((M, S))`` of host devices
and the port's world of ``M * S`` gloo processes (``launch.mesh.run_world``,
``rank = m * S + s``) start from the same global state (JAX's
``init_dist_state``, carried across with ``dist_state_from_arrays``) and
step through the same ``DistSampler`` batches. The metrics must agree
within 2e-5 and every table, accumulator and pend buffer within 2e-4 (the
pend ids exactly), each step's ``gather_dist_state`` against JAX's global
arrays.

The 1x2 world decides the gradient scale: the reference runs with
``check_vma=False``, so a psum's backward is a psum and the workspace
gradients on S servers are S times the unsharded ones (its pend buffer
holds 2x the 1x1 gradient). The port must give JAX's numbers.

One world runs every case of its shape (module fixtures), so each shape
is spawned once. The rank bodies live in ``_torch_dist_bodies.py``, which
imports no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_bodies as bodies
from repro.common.compat import set_mesh
from repro.common.config import KGEConfig as JaxCfg
from repro.core import distributed as JD
from repro.core.graph_part import partition as jax_partition
from repro.core.rel_part import relation_partition as jax_relation_partition
from repro.core.sampling import DistSampler as JaxDistSampler
from repro.data.kg_synth import fb15k_like
from repro.launch.mesh import make_mesh
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import distributed as TD
from repro_torch.core.graph_part import partition
from repro_torch.core.rel_part import relation_partition
from repro_torch.core.sampling import DistBatch, DistSampler
from repro_torch.launch import mesh as torch_mesh
from repro_torch.launch import train
from repro_torch.launch.mesh import run_world

torch.set_num_threads(2)

STEPS = 3
FWD = 2e-5  # metrics
TABLE = 2e-4  # tables, accumulators, pend grads
TIMEOUT_S = 120.0
PARITY_2X2 = [(model, overlap) for model in ("transe_l2", "transe_l1", "distmult")
              for overlap in (True, False)]
WIRE_BF16 = ("transe_l2", True, "bfloat16")  # KVStore rows and o/negs in bf16
LEARNS = [(model, overlap) for model in ("transe_l2", "distmult")
          for overlap in (True, False)]
PROJ_1X2 = ("transr", "rescal")


def _kw(kg, model, M, overlap, **over):
    kw = dict(model=model, n_entities=kg.n_entities, n_relations=kg.n_relations,
              dim=32, batch_size=32, neg_sample_size=16, neg_group_size=16,
              lr=0.1, n_parts=M, remote_capacity=64, overlap_update=overlap)
    if model == "transr":
        kw["rel_dim"] = 16
    kw.update(over)
    return kw


def _jax_case(kg, M, S, model, overlap=True, steps=STEPS, **over):
    """JAX's run on a (M, S) mesh and the port's inputs for the same run:
    ((torch prog, initial global arrays, batches), (metrics, final arrays))."""
    kw = _kw(kg, model, M, overlap, **over)
    jcfg = JaxCfg(**kw)
    book = jax_partition(kg.train, jcfg.n_entities, M, method="metis")
    rp = jax_relation_partition(kg.rel_counts(), M)
    jprog = JD.make_program(jcfg, book.rows_per_part, rp.slots_per_part, rp.n_shared)
    tprog = TD.make_program(TorchCfg(**kw), book.rows_per_part, rp.slots_per_part,
                            rp.n_shared)
    assert tprog.state_shapes() == {k: (sd.shape, np.dtype(sd.dtype))
                                    for k, sd in jprog.state_shapes().items()}
    assert tprog.batch_shapes() == {k: sd.shape
                                    for k, sd in jprog.batch_shapes().items()}
    sampler = JaxDistSampler(kg.train, book, rp, jcfg, np.random.default_rng(0))
    batches = [sampler.sample() for _ in range(steps)]
    init = {k: np.asarray(v) for k, v in
            JD.init_dist_state(jprog, jax.random.key(0)).items()}
    mesh = make_mesh((M, S), ("data", "model"))
    step, state_sh, batch_sh = JD.build_dist_train_step(jprog, mesh)
    hist = []
    with set_mesh(mesh):
        state = jax.device_put(init, state_sh)
        for db in batches:
            b = {k: jax.device_put(jnp.asarray(getattr(db, k)), batch_sh[k])
                 for k in batch_sh}
            state, m = step(state, b)
            hist.append({k: float(v) for k, v in m.items()})
    final = {k: np.asarray(v) for k, v in state.items()}
    port_batches = [DistBatch(**dataclasses.asdict(db)) for db in batches]
    return (tprog, init, port_batches), (hist, final)


def assert_runs_agree(got, want):
    (g_hist, g_state), (w_hist, w_state) = got, want
    assert len(g_hist) == len(w_hist)
    for gm, wm in zip(g_hist, w_hist):
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=FWD, atol=FWD, err_msg=k)
    assert set(g_state) == set(w_state)
    for k, want_arr in w_state.items():
        got_arr = g_state[k]
        assert got_arr.shape == want_arr.shape and got_arr.dtype == want_arr.dtype, k
        if k in ("pend_ids", "step"):
            np.testing.assert_array_equal(got_arr, want_arr, err_msg=k)
        else:
            np.testing.assert_allclose(got_arr, want_arr, rtol=TABLE, atol=TABLE,
                                       err_msg=k)


@pytest.fixture(scope="module")
def world_2x2(small_kg):
    """The 2x2 parity cases and the 12-step learning runs, in one world."""
    jax_cases = {c: _jax_case(small_kg, 2, 2, *c) for c in PARITY_2X2}
    model, overlap, wire = WIRE_BF16
    jax_cases[WIRE_BF16] = _jax_case(small_kg, 2, 2, model, overlap, comm_dtype=wire)
    learn_inputs = {}
    for model, overlap in LEARNS:
        cfg = TorchCfg(**_kw(small_kg, model, 2, overlap, batch_size=64,
                             neg_sample_size=32, neg_group_size=0))
        book = partition(small_kg.train, cfg.n_entities, 2, method="metis")
        rp = relation_partition(small_kg.rel_counts(), 2)
        prog = TD.make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared)
        sampler = DistSampler(small_kg.train, book, rp, cfg, np.random.default_rng(0))
        learn_inputs[(model, overlap)] = (prog, TD.init_dist_arrays(prog, 0),
                                          [sampler.sample() for _ in range(12)])
    parity_keys = [*PARITY_2X2, WIRE_BF16]
    cases = [jax_cases[c][0] for c in parity_keys] + [learn_inputs[c] for c in LEARNS]
    out = run_world(2, 2, bodies.run_cases, (cases,), timeout_s=TIMEOUT_S)
    parity = {c: (out[i], jax_cases[c][1]) for i, c in enumerate(parity_keys)}
    learns = {c: out[len(parity_keys) + i] for i, c in enumerate(LEARNS)}
    return parity, learns


@pytest.fixture(scope="module")
def world_1x2(small_kg):
    """S = 2 servers: TransE_l2 (the negative-sharded route) and the
    projection models (the sliced/gathered psum route), plus JAX's 1x1
    TransE_l2 step for the gradient scale."""
    jax_cases = {"transe_l2": _jax_case(small_kg, 1, 2, "transe_l2")}
    jax_cases.update({m: _jax_case(small_kg, 1, 2, m) for m in PROJ_1X2})
    out = run_world(1, 2, bodies.run_cases, ([c[0] for c in jax_cases.values()],),
                    timeout_s=TIMEOUT_S)
    unsharded = _jax_case(small_kg, 1, 1, "transe_l2", steps=1)[1][1]
    sharded_1 = _jax_case(small_kg, 1, 2, "transe_l2", steps=1)[1][1]
    runs = {name: (got, case[1]) for (name, case), got in zip(jax_cases.items(), out)}
    return runs, unsharded, sharded_1


@pytest.mark.parametrize("overlap", [True, False], ids=["t5", "no_t5"])
@pytest.mark.parametrize("model", ["transe_l2", "transe_l1", "distmult"])
def test_step_matches_jax_2x2(world_2x2, model, overlap):
    got, want = world_2x2[0][(model, overlap)]
    assert_runs_agree(got, want)
    assert got[1]["step"] == STEPS


def test_bf16_wire_matches_jax_2x2(world_2x2):
    """``comm_dtype="bfloat16"``: remote rows, pushed grads and the
    negative-sharded route's o/negs cross the wire in bf16, as in JAX."""
    got, want = world_2x2[0][WIRE_BF16]
    assert_runs_agree(got, want)


def test_transr_2x1_matches_jax(small_kg):
    """TransR: the non-sharded route (the psum of pairwise partials) and the
    projection store, on two machines of one server."""
    inputs, want = _jax_case(small_kg, 2, 1, "transr", lr=0.05)
    got = run_world(2, 1, bodies.run_cases, ([inputs],), timeout_s=TIMEOUT_S)[0]
    assert_runs_agree(got, want)


def test_gradient_scale_1x2_matches_jax(world_1x2):
    runs, unsharded, sharded_1 = world_1x2
    assert_runs_agree(*runs["transe_l2"])
    # the reference's own scale: one step's deferred gradient on 2 servers
    # is twice the unsharded one, and its accumulator 4x, as the port's is
    np.testing.assert_allclose(sharded_1["pend_grads"], 2 * unsharded["pend_grads"],
                               rtol=TABLE, atol=1e-6)


@pytest.mark.parametrize("model", PROJ_1X2)
def test_projection_models_1x2_match_jax(world_1x2, model):
    assert_runs_agree(*world_1x2[0][model])


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("model", ["transe_l2", "distmult"])
def test_dist_training_learns(world_2x2, model, overlap):
    hist, state = world_2x2[1][(model, overlap)]
    losses = [m["loss"] for m in hist]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert state["step"] == 12 and np.isfinite(state["entity"]).all()


def _cli(*extra):
    return train.main(["--device", "cpu", "--distributed", "--mesh", "2x1",
                       "--scale", "0.02", "--dim", "16", "--batch-size", "32",
                       "--neg", "8", "--log-every", "3", *extra])


def test_cli_checkpoint_has_jax_layout_and_resumes(tmp_path, capsys):
    """``--distributed --mesh 2x1 --device cpu`` with checkpoints: the loss
    line carries the drop rate, the checkpoint holds the global state under
    JAX's keys, shapes and dtypes (JAX's ``restore_checkpoint`` reads it
    back bit for bit), and ``--resume`` goes on from it."""
    from repro.common.checkpoint import restore_checkpoint as jax_restore

    ck = tmp_path / "ck"
    cfg, final = _cli("--steps", "6", "--ckpt-dir", str(ck), "--save-every", "3")
    out = capsys.readouterr().out
    assert "partitioner=metis cut=" in out and "step      6 loss" in out
    assert "drop " in out and out.strip().endswith("done")
    assert final["step"] == 6

    kg = fb15k_like(scale=0.02, seed=0)
    jcfg = JaxCfg(**dataclasses.asdict(cfg))
    book = jax_partition(kg.train, jcfg.n_entities, 2, method="metis", seed=0)
    rp = jax_relation_partition(kg.rel_counts(), 2, seed=0)
    shapes = JD.make_program(jcfg, book.rows_per_part, rp.slots_per_part,
                             rp.n_shared).state_shapes()
    assert sorted(p.name for p in ck.iterdir()) == ["step_0000000003",
                                                    "step_0000000006"]
    restored = jax_restore(str(ck), shapes)
    assert set(restored) == set(final) == set(shapes)
    for k, sd in shapes.items():
        assert restored[k].shape == sd.shape and restored[k].dtype == sd.dtype, k
        np.testing.assert_array_equal(np.asarray(restored[k]), final[k], err_msg=k)

    cfg2, final2 = _cli("--steps", "9", "--ckpt-dir", str(ck), "--resume")
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step      9 loss" in out
    assert final2["step"] == 9 and np.isfinite(final2["entity"]).all()
    assert not np.array_equal(final2["entity"], final["entity"])


def test_make_program_validates_like_jax(small_kg):
    """The reference's validation, then pipelined I/O accepted with T5 off:
    the same programs as JAX's (fields and state shapes)."""
    kw = _kw(small_kg, "transe_l2", 2, True)
    args = (100, 8, 1)
    for over, prog_kw in ((dict(), dict(pipeline_depth=2)),
                          (dict(), dict(push_every=0)),
                          (dict(model="transr", rel_dim=16, overlap_update=False),
                           dict(pipeline_depth=1)),
                          (dict(), dict(push_every=2))):
        for make, cfg_cls in ((JD.make_program, JaxCfg), (TD.make_program, TorchCfg)):
            with pytest.raises(ValueError):
                make(cfg_cls(**dict(kw, **over)), *args, **prog_kw)
    no_t5 = dict(kw, overlap_update=False)
    for prog_kw in (dict(pipeline_depth=1), dict(push_every=2),
                    dict(pipeline_depth=1, push_every=4)):
        jprog = JD.make_program(JaxCfg(**no_t5), *args, **prog_kw)
        tprog = TD.make_program(TorchCfg(**no_t5), *args, **prog_kw)
        assert (tprog.pipeline_depth, tprog.push_every, tprog.coalesce_slots) == (
            jprog.pipeline_depth, jprog.push_every, jprog.coalesce_slots)
        assert tprog.state_shapes() == {k: (sd.shape, np.dtype(sd.dtype))
                                        for k, sd in jprog.state_shapes().items()}


def test_cuda_world_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        torch_mesh.check_devices(2, 2, "cuda")
    assert torch_mesh.check_devices(1, 1, "cuda").type == "cuda"
    with pytest.raises(ValueError, match="MxS"):
        torch_mesh.parse_mesh("2x2x2")
