"""The port's checkpoints against the JAX package's (same files both ways),
and resume.

The JAX ``KGEState`` is a pytree: its leaves are named by field, None
fields are no leaves, ``step`` is a 0-d int32 and ``pend_ids`` int32. The
port writes the same files, so a checkpoint saved by either package
restores in the other, bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.common import checkpoint as JC
from repro.common.config import KGEConfig as JaxCfg
from repro.core import kge_model as JK
from repro.data.kg_synth import make_synthetic_kg
from repro_torch.common import checkpoint as TC
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import kge_model as TK
from repro_torch.core.sampling import JointSampler
from repro_torch.launch import engine, train

torch.set_num_threads(2)

N_ENT, N_REL = 200, 8
KW = dict(n_entities=N_ENT, n_relations=N_REL, dim=16, batch_size=32,
          neg_sample_size=8, gamma=12.0, lr=0.1)


def _jax_state(model, overlap):
    jc = JaxCfg(model=model, **KW)
    js = JK.init_state(jc, jax.random.key(0), overlap=overlap)
    # non-trivial accumulators, step and pend ids, so every leaf is checked
    js.ent_gsq = js.ent_gsq + 0.5
    js.step = js.step + 7
    if overlap:
        js.pend_ids = js.pend_ids.at[:3].set(np.array([4, 9, 1], np.int32))
        js.pend_grads = js.pend_grads + 0.25
    return jc, js


def _port_state(model, overlap, seed=0):
    return TK.init_state(TorchCfg(model=model, **KW), torch.Generator().manual_seed(seed),
                         overlap=overlap, device="cpu")


def _assert_same(port_state, jax_state):
    got = TK.state_to_arrays(port_state)
    for name in TK.ARRAY_FIELDS:
        want = getattr(jax_state, name)
        if want is None:
            assert got[name] is None, name
        else:
            assert got[name].dtype == np.asarray(want).dtype, name
            np.testing.assert_array_equal(got[name], np.asarray(want), err_msg=name)


@pytest.mark.parametrize("model", ["transe_l1", "transr"])
@pytest.mark.parametrize("overlap", [True, False], ids=["t5", "no_t5"])
def test_jax_saves_port_restores(tmp_path, model, overlap):
    _, js = _jax_state(model, overlap)
    JC.save_checkpoint(str(tmp_path), 7, js)
    back = TC.restore_checkpoint(str(tmp_path), _port_state(model, overlap, seed=1))
    assert back.step == 7 and isinstance(back.step, int)
    _assert_same(back, js)


@pytest.mark.parametrize("model", ["transe_l1", "transr"])
@pytest.mark.parametrize("overlap", [True, False], ids=["t5", "no_t5"])
def test_port_saves_jax_restores(tmp_path, model, overlap):
    jc, like = _jax_state(model, overlap)
    ts = _port_state(model, overlap)
    ts.step = 11
    if overlap:  # ids are int64 in the port's state after a step
        ts.pend_ids = torch.arange(ts.pend_ids.shape[0], dtype=torch.int64) - 5
    TC.save_checkpoint(str(tmp_path), 11, ts)
    meta = json.loads((tmp_path / "step_0000000011" / "metadata.json").read_text())
    assert meta["leaves"]["step"] == {"file": "step.npy", "dtype": "int32", "shape": []}
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), like)
    back = JC.restore_checkpoint(str(tmp_path), abstract)
    _assert_same(ts, back)
    assert set(meta["leaves"]) == set(JC._flatten(like))


def test_latest_step_prune_and_checks(tmp_path):
    ts = _port_state("transe_l1", False)
    assert TC.latest_step(str(tmp_path / "none")) is None
    for s in (1, 5, 9, 12):
        TC.save_checkpoint(str(tmp_path), s, ts, keep=2)
    assert TC.latest_step(str(tmp_path)) == 12
    assert sorted(os.listdir(tmp_path)) == ["step_0000000009", "step_0000000012"]
    back = TC.restore_checkpoint(str(tmp_path), ts, step=9)
    torch.testing.assert_close(back.entity, ts.entity, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        TC.restore_checkpoint(str(tmp_path), TK.init_state(
            TorchCfg(model="transe_l1", **dict(KW, dim=8)), device="cpu"))
    with pytest.raises(KeyError, match="pend_ids"):
        TC.restore_checkpoint(str(tmp_path), _port_state("transe_l1", True))
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(str(tmp_path / "none"), ts)


def test_leftover_tmp_is_no_step(tmp_path):
    """A ``step_<n>.tmp`` left by a save that died before its rename is no
    checkpoint: ``latest_step`` and pruning pass it by. Here the port differs
    on purpose from the JAX package, whose ``latest_step`` takes every
    ``step_`` entry and raises on ``int('<n>.tmp')`` when the leftover is the
    newest."""
    ts = _port_state("transe_l1", False)
    for s in (2, 4):
        TC.save_checkpoint(str(tmp_path), s, ts, keep=2)
    (tmp_path / "step_0000000007.tmp").mkdir()
    assert TC.latest_step(str(tmp_path)) == 4
    with pytest.raises(ValueError):
        JC.latest_step(str(tmp_path))
    TC.save_checkpoint(str(tmp_path), 6, ts, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000004", "step_0000000006",
                                            "step_0000000007.tmp"]
    assert TC.latest_step(str(tmp_path)) == 6
    back = TC.restore_checkpoint(str(tmp_path), ts)
    torch.testing.assert_close(back.entity, ts.entity, rtol=0, atol=0)


@pytest.mark.parametrize("overlap", [True, False], ids=["t5", "no_t5"])
def test_resume_equals_straight_run(tmp_path, overlap):
    """A run that saves (flushed) at step 3 and goes on to 6, and a restore
    of step 3 into a fresh state that steps on to 6, both give the tables of
    6 straight steps, bit for bit."""
    cfg = TorchCfg(model="transe_l1", **KW)
    kg = make_synthetic_kg(n_entities=N_ENT, n_relations=N_REL, n_edges=2000,
                           n_clusters=4, seed=0)
    sampler = JointSampler(kg.train, N_ENT, cfg, np.random.default_rng(0))
    batches = [TK.batch_to_device(sampler.sample(), "cpu") for _ in range(6)]

    def run(state, start, n_steps, hooks):
        it = iter(batches[start:n_steps])
        return engine.train_loop(lambda s, b: TK.train_step(cfg, s, b), state,
                                 lambda: (next(it), None), n_steps, start=start,
                                 hooks=hooks)

    flush = lambda s: TK.flush_state(cfg, s)
    straight = flush(run(_port_state("transe_l1", overlap), 0, 6, []))
    saving = flush(run(_port_state("transe_l1", overlap), 0, 6,
                       [engine.CheckpointHook(str(tmp_path), 3, flush)]))
    assert TC.latest_step(str(tmp_path)) == 6
    restored = TC.restore_checkpoint(str(tmp_path), _port_state("transe_l1", overlap, 1),
                                     step=3)
    assert restored.step == 3
    assert torch.equal(restored.entity, torch.from_numpy(
        np.load(tmp_path / "step_0000000003" / "entity.npy")))
    resumed = flush(run(restored, restored.step, 6, []))
    assert resumed.step == straight.step == 6
    for name in ("entity", "ent_gsq", "r_emb", "rel_gsq"):
        assert torch.equal(getattr(saving, name), getattr(straight, name)), name
        assert torch.equal(getattr(resumed, name), getattr(straight, name)), name


def test_cli_saves_evaluates_and_resumes(tmp_path, capsys):
    flags = ["--device", "cpu", "--model", "transe_l1", "--scale", "0.02",
             "--dim", "16", "--batch-size", "32", "--neg", "8", "--eval",
             "--eval-n", "50", "--ckpt-dir", str(tmp_path), "--save-every", "3",
             "--log-every", "3"]
    train.main(flags + ["--steps", "6"])
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000006"]
    _, state = train.main(flags + ["--steps", "9", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step      9 loss" in out
    assert out.count("eval: MRR") == 2 and state.step == 9
    assert TC.latest_step(str(tmp_path)) == 9
