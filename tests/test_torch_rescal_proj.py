"""RESCAL's projection products in one op (kernels/rescal_proj) on the CPU:
its plain version against the einsums of core/scores.py that it replaces,
float64 gradients by finite differences, and the single-machine step that
takes it against the step over per-triplet copies. The CUDA kernels are
held to the plain version on the card in tests/test_torch_cuda.py."""

import json

import numpy as np
import pytest
import torch

from repro_torch.common import telemetry
from repro_torch.common.config import KGEConfig
from repro_torch.core import kge_model as K
from repro_torch.core import scores as S
from repro_torch.core.step import store_grads
from repro_torch.kernels.rescal_proj.ops import rescal_proj

# (b, d, rel_dim): square as RESCAL's, d != rel_dim, an odd width
SHAPES = [(6, 8, 8), (5, 6, 9), (4, 7, 13)]


def _operands(b, d, r, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype, requires_grad=True)

    return draw(b, d * r), draw(b, d), draw(b, r)


def _einsum_products(m, h, t, r):
    """The step's einsum route: a per-triplet copy of the workspace rows,
    then scores.neg_o's two products (tail: M^T h; head: M t, whose
    einsum neg_o spells for RESCAL's square matrices only)."""
    ctx = S.ShardCtx(None)
    pr = m[torch.arange(m.shape[0])]
    ph = S.neg_o("rescal", h, None, "tail", ctx, pr, r)
    if h.shape[-1] == r:
        return ph, S.neg_o("rescal", t, None, "head", ctx, pr, r)
    return ph, torch.einsum("...dr,...r->...d", pr.reshape(-1, h.shape[-1], r), t)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_op_matches_the_einsums_it_replaces(shape, dtype, tol):
    b, d, r = shape
    m, h, t = _operands(b, d, r, dtype)
    rng = np.random.default_rng(1)
    wph = torch.tensor(rng.standard_normal((b, r)), dtype=dtype)
    wpt = torch.tensor(rng.standard_normal((b, d)), dtype=dtype)
    got, want = rescal_proj(m, h, t), _einsum_products(m, h, t, r)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    grads = [torch.autograd.grad((ph * wph).sum() + (pt * wpt).sum(), (m, h, t))
             for ph, pt in (got, want)]
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_op_gradcheck(shape):
    b, d, r = shape
    assert torch.autograd.gradcheck(rescal_proj, _operands(b, d, r, torch.float64))


def _rescal_setup(seed=0):
    from repro_torch.core.sampling import JointSampler
    from repro_torch.data.kg_synth import make_synthetic_kg

    kg = make_synthetic_kg(n_entities=120, n_relations=9, n_edges=1500,
                           n_clusters=3, seed=seed)
    cfg = KGEConfig(model="rescal", n_entities=kg.n_entities, n_relations=kg.n_relations,
                    dim=12, batch_size=32, neg_sample_size=8, neg_group_size=8,
                    lr=0.05)
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(seed))
    state = K.init_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return cfg, state, [K.batch_to_device(sampler.sample(), "cpu") for _ in range(2)]


def test_store_grads_fused_route_equals_einsum_route():
    """The same batch lowered as the single-machine step does (which states
    rel_slot_is_arange) and without that statement: one op over the
    workspace against the einsums over per-triplet copies. Loss and every
    table's grads within 1e-6 relative; each route counted once a step."""
    cfg, state, batches = _rescal_setup()
    stores = K.stores_from_state(cfg, state)
    for raw in batches:
        fused = K.dense_step_batch(raw)
        assert fused["rel_slot_is_arange"] is True
        plain = {k: v for k, v in fused.items() if k != "rel_slot_is_arange"}
        with telemetry.active() as reg:
            got, gm = store_grads(cfg, stores, fused)
            want, wm = store_grads(cfg, stores, plain)
        assert reg.counters == {"scores/rescal_proj_fused": 1.0,
                                "scores/rescal_proj_einsum": 1.0}
        torch.testing.assert_close(gm["loss"], wm["loss"], rtol=1e-6, atol=0)
        assert set(got) == set(want) == {"entity", "rel", "proj"}
        for name in got:
            scale = float(want[name].abs().max())
            assert float((got[name] - want[name]).abs().max()) <= 1e-6 * max(scale, 1e-30), name
        assert not got["rel"].any()  # RESCAL's score never reads the relation rows


def test_route_counters_pass_the_validator(tmp_path):
    """The route counters are port-only names that the port's validator
    accepts beside the JAX package's schema."""
    cfg, state, batches = _rescal_setup(seed=1)
    with telemetry.active() as reg:
        for raw in batches:
            state, _ = K.train_step(cfg, state, raw)
        reg.inc("engine/steps", len(batches))
        path = tmp_path / "m.jsonl"
        path.write_text(json.dumps(reg.snapshot(step=len(batches))) + "\n")
    assert reg.counters["scores/rescal_proj_fused"] == len(batches)
    assert telemetry.validate_metrics_jsonl(str(path)) == 1
