"""Several trainers and samplers on the distributed path, port vs JAX package.

``python -m repro_torch.launch.train --distributed --trainers N --samplers
N`` runs the runtime's ordered mode on every rank of a gloo world: step t
takes sampler ``t mod N``'s batch (the samplers built from ``worker_rngs``,
the same on every rank) and the steps, with their hooks, pass in that
order. JAX's ``build_dist_train_step`` on a 2x2 host mesh, fed that
round-robin sequence from its own ``DistSampler``s and started from the
port's initial tables, is the reference: every step's metrics within 2e-5,
the final tables, accumulators and pend grads within 2e-4, the pend ids and
the step exactly. Every rank must step one batch sequence (a digest of each
whole batch, recorded by a hook on every rank), take part in each
checkpoint gather at the same step, and resume from the saved state.

One 2x2 world runs every CLI case (module fixture); the rank bodies live in
``_torch_dist_bodies.py``, which imports no JAX.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_bodies as bodies
from repro.common.checkpoint import restore_checkpoint as jax_restore
from repro.common.compat import set_mesh
from repro.common.config import KGEConfig as JaxCfg
from repro.core import distributed as JD
from repro.core.graph_part import partition as jax_partition
from repro.core.rel_part import relation_partition as jax_relation_partition
from repro.core.sampling import DistSampler as JaxDistSampler
from repro.data.kg_synth import fb15k_like as jax_fb15k_like
from repro.data.pipeline import worker_rngs as jax_worker_rngs
from repro.launch.mesh import make_mesh
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import distributed as TD
from repro_torch.core.graph_part import partition
from repro_torch.core.rel_part import relation_partition
from repro_torch.core.sampling import DistSampler
from repro_torch.data.pipeline import worker_rngs
from repro_torch.launch import train
from repro_torch.launch.mesh import run_world

torch.set_num_threads(2)

FWD = 2e-5  # metrics
TABLE = 2e-4  # tables, accumulators, pend grads
TIMEOUT_S = 120.0
STEPS, SAVE_EVERY, RESUMED_STEPS = 6, 2, 8
BASE = ["--device", "cpu", "--distributed", "--mesh", "2x2", "--scale", "0.02",
        "--dim", "16", "--batch-size", "32", "--neg", "8", "--log-every", "3"]
# name -> (trainers, samplers); the first also checkpoints every SAVE_EVERY
CASES = {"t2_s2": (2, 2), "t2_s1": (2, 1), "t1_s2": (1, 2)}
EXACT = ("pend_ids", "step")


def _argv(trainers, samplers, *extra):
    return [*BASE, "--trainers", str(trainers), "--samplers", str(samplers), *extra]


def _samplers(make, kg, book, rp, cfg, rngs, n):
    """The CLI's samplers: the seed's own stream for one, else ``rngs``."""
    return ([make(kg.train, book, rp, cfg, np.random.default_rng(0))] if n <= 1
            else [make(kg.train, book, rp, cfg, r) for r in rngs(0, n)])


def _round_robin(samplers, steps):
    """Step t takes sampler ``t mod N``'s next batch."""
    return [samplers[t % len(samplers)].sample() for t in range(steps)]


class Reference:
    """JAX's step on a 2x2 mesh for the CLI's config, and the port's
    program, initial tables and batches for the same run."""

    def __init__(self, cfg):
        self.kg = jax_fb15k_like(scale=0.02, seed=0)
        self.jcfg = JaxCfg(**dataclasses.asdict(cfg))
        self.book = jax_partition(self.kg.train, cfg.n_entities, 2, method="metis", seed=0)
        self.rp = jax_relation_partition(self.kg.rel_counts(), 2, seed=0)
        args = (self.book.rows_per_part, self.rp.slots_per_part, self.rp.n_shared)
        self.jprog = JD.make_program(self.jcfg, *args)
        self.tprog = TD.make_program(cfg, *args)
        self.init = TD.init_dist_arrays(self.tprog, 0)  # the CLI's --seed 0 tables
        self.mesh = make_mesh((2, 2), ("data", "model"))
        self.step, self.state_sh, self.batch_sh = JD.build_dist_train_step(
            self.jprog, self.mesh)
        # the port's samplers on the port's partition (the CLI's own)
        tbook = partition(self.kg.train, cfg.n_entities, 2, method="metis", seed=0)
        trp = relation_partition(self.kg.rel_counts(), 2, seed=0)
        np.testing.assert_array_equal(tbook.part_of, self.book.part_of)
        self.port = (tbook, trp, cfg)

    def batches(self, n_samplers, steps):
        """The round-robin sequence, from JAX's samplers and from the
        port's; the two must be equal array for array."""
        jax_b = _round_robin(_samplers(JaxDistSampler, self.kg, self.book, self.rp,
                                       self.jcfg, jax_worker_rngs, n_samplers), steps)
        port_b = _round_robin(_samplers(DistSampler, self.kg, *self.port, worker_rngs,
                                        n_samplers), steps)
        for j, t in zip(jax_b, port_b):
            for f in dataclasses.fields(t):
                np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name))
        return jax_b, port_b

    def run(self, init, batches):
        """Each step's metrics and the global state after each step."""
        hist, after = [], []
        with set_mesh(self.mesh):
            state = jax.device_put(init, self.state_sh)
            for db in batches:
                b = {k: jax.device_put(jnp.asarray(getattr(db, k)), self.batch_sh[k])
                     for k in self.batch_sh}
                state, m = self.step(state, b)
                hist.append({k: float(v) for k, v in m.items()})
                after.append({k: np.asarray(v) for k, v in state.items()})
        return hist, after


def assert_states_agree(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=TABLE, atol=TABLE, err_msg=k)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every CLI case, then the resume of the first, in one 2x2 gloo world;
    and JAX's reference for the CLI's config."""
    ck = tmp_path_factory.mktemp("dist_hogwild") / "ck"
    argvs = [_argv(*CASES["t2_s2"], "--steps", str(STEPS), "--ckpt-dir", str(ck),
                   "--save-every", str(SAVE_EVERY))]
    argvs += [_argv(*CASES[name], "--steps", str(STEPS)) for name in ("t2_s1", "t1_s2")]
    argvs.append(_argv(*CASES["t2_s2"], "--steps", str(RESUMED_STEPS), "--ckpt-dir",
                       str(ck), "--resume"))
    runs = run_world(2, 2, bodies.cli_runs, (argvs,), timeout_s=TIMEOUT_S)
    ref = Reference(runs[0][0])
    return dict(zip([*CASES, "resume"], runs)), ref, ck


@pytest.mark.parametrize("case", list(CASES))
def test_cli_trainers_and_samplers_match_jax(world, case):
    """Each step's metrics and the final global state against JAX's step
    fed the same round-robin batch sequence."""
    runs, ref, _ = world
    cfg, final, metrics, _ = runs[case]
    assert cfg.overlap_update  # T5 stays on, as in JAX's distributed run
    jax_b, _ = ref.batches(CASES[case][1], STEPS)
    hist, after = ref.run(ref.init, jax_b)
    assert len(metrics) == len(hist) == STEPS
    for got, want in zip(metrics, hist):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=FWD, atol=FWD, err_msg=k)
    assert_states_agree(final, after[-1])
    assert final["step"] == STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_steps_one_batch_sequence(world, case):
    """All four ranks step batches 1..STEPS in one order, each the whole
    batch of the round-robin sequence (its digest), by trainers 0..N-1."""
    runs, ref, _ = world
    records = runs[case][3]
    n_trainers, n_samplers = CASES[case]
    _, port_b = ref.batches(n_samplers, STEPS)
    want = [(i + 1, bodies.batch_digest(db)) for i, db in enumerate(port_b)]
    assert len(records) == 4
    for rank, (steps, _) in enumerate(records):
        assert [(i, d) for i, d, _ in steps] == want, f"rank {rank}"
        assert {t for _, _, t in steps} <= set(range(n_trainers)), f"rank {rank}"
        assert steps[0][2] == 0  # trainer 0 takes step 1 first
    assert len({d for _, d in want}) == STEPS  # the samplers' batches differ


def test_save_every_under_two_trainers(world):
    """``--save-every 2`` with two trainers: every rank takes part in each
    checkpoint gather at the same step; each checkpoint holds JAX's state
    after its step, in JAX's layout; the last one restores bit for bit."""
    runs, ref, ck = world
    _, final, _, records = runs["t2_s2"]
    saves = list(range(SAVE_EVERY, STEPS + 1, SAVE_EVERY))
    for rank, (_, gathers) in enumerate(records):
        assert gathers == [*saves, STEPS], f"rank {rank}"  # then the final gather
    assert sorted(p.name for p in ck.iterdir()) == [
        f"step_{s:010d}" for s in (*saves, RESUMED_STEPS)][-3:]  # keep=3
    jax_b, _ = ref.batches(2, STEPS)
    _, after = ref.run(ref.init, jax_b)
    shapes = ref.jprog.state_shapes()
    for s in saves[1:]:  # step 2 was pruned by the resumed run's save
        restored = jax_restore(str(ck), shapes, step=s)
        for k, sd in shapes.items():
            assert restored[k].shape == sd.shape and restored[k].dtype == sd.dtype, k
        assert_states_agree({k: np.asarray(v) for k, v in restored.items()}, after[s - 1])
    last = jax_restore(str(ck), shapes, step=STEPS)
    for k in shapes:
        np.testing.assert_array_equal(np.asarray(last[k]), final[k], err_msg=k)


def test_resume_under_two_trainers(world):
    """``--resume --steps 8`` goes on from the step-6 checkpoint on every
    rank: steps 7 and 8, on the restarted samplers' first two batches, to
    JAX's state from the same checkpoint."""
    runs, ref, _ = world
    _, final, metrics, records = runs["resume"]
    jax_b, port_b = ref.batches(2, RESUMED_STEPS - STEPS)
    for rank, (steps, gathers) in enumerate(records):
        assert [(i, d) for i, d, _ in steps] == [
            (STEPS + 1 + t, bodies.batch_digest(db)) for t, db in enumerate(port_b)
        ], f"rank {rank}"
        assert gathers == [RESUMED_STEPS, RESUMED_STEPS], f"rank {rank}"  # save, final
    start = {k: np.asarray(v) for k, v in runs["t2_s2"][1].items()}
    hist, after = ref.run(start, jax_b)
    for got, want in zip(metrics, hist):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=FWD, atol=FWD, err_msg=k)
    assert_states_agree(final, after[-1])
    assert final["step"] == RESUMED_STEPS


@pytest.mark.parametrize("pipelined", [["--pipeline-depth", "1"], ["--push-every", "2"]])
@pytest.mark.parametrize("flag", ["--trainers", "--samplers"])
def test_pipelined_flags_with_workers_stay_refused(flag, pipelined):
    """JAX's SystemExit, word for word."""
    with pytest.raises(SystemExit) as err:
        train.main([*BASE, flag, "2", *pipelined])
    assert str(err.value.code) == (
        "--pipeline-depth/--push-every are incompatible with --trainers/"
        "--samplers > 1 (the lookahead is single-consumer; see "
        "launch/engine.train_loop)")


def test_a_failing_rank_ends_the_world(small_kg):
    """A sampler of rank 1 raises at its second batch (step 4 of 6, in the
    middle of the run): the world ends with an error within its timeout,
    rank 0 waiting in no collective for ever."""
    cfg = TorchCfg(model="transe_l2", n_entities=small_kg.n_entities,
                   n_relations=small_kg.n_relations, dim=16, batch_size=32,
                   neg_sample_size=8, lr=0.1, n_parts=2, remote_capacity=64)
    book = partition(small_kg.train, cfg.n_entities, 2)
    rp = relation_partition(small_kg.rel_counts(), 2)
    prog = TD.make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared)
    sampler = DistSampler(small_kg.train, book, rp, cfg, np.random.default_rng(0))
    batches = [sampler.sample() for _ in range(6)]
    timeout_s = 30.0
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        run_world(2, 1, bodies.failing_sampler_run, (prog, batches, 2),
                  timeout_s=timeout_s)
    assert time.monotonic() - t0 < timeout_s + 30.0
