"""The port's link-prediction evaluation against the JAX package's.

Both packages rank the same test triplets of a small synthetic graph from
the same tables (JAX-initialised, carried across with ``state_from_arrays``,
and trained a few steps by JAX so the scores are not those of a random
model). Ranks use a strict ``>``, so a score that rounds differently in the
two frameworks can move a near-tie: at least 99% of ranks must be equal, and
the metrics within 1e-3 — in protocol 2 over the queries whose own answer
was not drawn as a candidate (see its test).
"""

import jax
import numpy as np
import pytest
import torch

from repro.common.config import KGEConfig as JaxCfg
from repro.core import eval as JE
from repro.core import kge_model as JK
from repro.core.sampling import JointSampler as JaxJointSampler
from repro.data.kg_synth import make_synthetic_kg
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import eval as TE
from repro_torch.core import kge_model as TK

torch.set_num_threads(2)

N_ENT, N_REL, N_TEST = 300, 12, 60


@pytest.fixture(scope="module")
def kg():
    return make_synthetic_kg(n_entities=N_ENT, n_relations=N_REL, n_edges=3000,
                             n_clusters=4, seed=0)


def _states(kg, model, steps=3):
    kw = dict(model=model, n_entities=N_ENT, n_relations=N_REL, dim=32,
              batch_size=64, neg_sample_size=16, gamma=12.0, lr=0.1)
    jc, tc = JaxCfg(**kw), TorchCfg(**kw)
    js = JK.init_state(jc, jax.random.key(0))
    sampler = JaxJointSampler(kg.train, N_ENT, jc, np.random.default_rng(0))
    for _ in range(steps):
        js, _ = JK.train_step(jc, js, JK.batch_to_device(sampler.sample()))
    arrays = {f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
              for f in TK.ARRAY_FIELDS}
    return jc, js, tc, TK.state_from_arrays(tc, arrays, device="cpu")


def _assert_ranks_agree(got, want):
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.99, np.flatnonzero(got != want)
    gm, wm = TE.metrics_from_ranks(got).row(), JE.metrics_from_ranks(want).row()
    for k in ("mrr", "hits1", "hits3", "hits10"):
        assert abs(gm[k] - wm[k]) <= 1e-3, k
    assert abs(gm["mr"] - wm["mr"]) <= 1e-3 * wm["mr"]


@pytest.mark.parametrize("model", ["transe_l1", "transe_l2", "distmult", "rotate"])
def test_protocol1_filtered_ranks_match_jax(kg, model):
    jc, js, tc, ts = _states(kg, model)
    test = kg.test[:N_TEST]
    fm = JE.build_filter_map(kg.triplets)
    want = JE.ranks_against_all(jc, js, test, filter_map=fm)
    got = TE.ranks_against_all(tc, ts, test, filter_map=TE.build_filter_map(kg.triplets),
                               chunk=16)
    assert got.shape == (2 * N_TEST,)
    _assert_ranks_agree(got, want)
    # the filter only removes competitors: no rank gets worse
    assert (got <= TE.ranks_against_all(tc, ts, test)).all()


def _truth_copies(test, deg, rng, n_uniform, n_degree, chunk):
    """How often each query's own answer is among its protocol-2
    candidates, replaying the candidate draws of ``ranks_protocol2``."""
    p = deg / deg.sum()
    out = []
    for col in (2, 0):  # tail side, then head side
        for i in range(0, test.shape[0], chunk):
            ch = test[i: i + chunk]
            q = ch.shape[0]
            cand = np.concatenate([rng.integers(0, N_ENT, size=(q, n_uniform)),
                                   rng.choice(N_ENT, size=(q, n_degree), p=p)], 1)
            out.extend((cand == ch[:, col, None]).sum(1))
    return np.asarray(out)


@pytest.mark.parametrize("model", ["transe_l1", "complex"])
def test_protocol2_ranks_match_jax(kg, model):
    """Protocol 2 is unfiltered: a query's own answer may be drawn as a
    candidate, and then it ties with the positive score up to rounding
    (the two are summed in other orders), so either package may count it.
    Every other query's rank must be equal, and those ranks differ by at
    most the answer's copies among the candidates."""
    jc, js, tc, ts = _states(kg, model)
    test = kg.test[:N_TEST]
    deg = kg.degrees().astype(np.float64)
    kw = dict(n_uniform=40, n_degree=40, chunk=25, q_chunk=7)
    want = JE.ranks_protocol2(jc, js, test, deg, rng=np.random.default_rng(3), **kw)
    got = TE.ranks_protocol2(tc, ts, test, deg, rng=np.random.default_rng(3), **kw)
    copies = _truth_copies(test, deg, np.random.default_rng(3), 40, 40, 25)
    clean = copies == 0
    assert clean.mean() >= 0.5
    _assert_ranks_agree(got[clean], want[clean])
    assert (np.abs(got - want) <= copies).all()


def test_candidate_scores_q_chunk_invariant(kg):
    """Per-query candidates are scored as grouped calls of q_chunk queries;
    the chunking (with a ragged tail) changes no score and no rank."""
    _, _, tc, ts = _states(kg, "transe_l1", steps=0)
    rng = np.random.default_rng(0)
    test = kg.test[:10]
    h, r, t = (torch.as_tensor(test[:, j], dtype=torch.int64) for j in range(3))
    cand = torch.as_tensor(rng.integers(0, N_ENT, (10, 50)), dtype=torch.int64)
    full = TE._candidate_scores(tc, ts, h, r, t, cand, "tail", q_chunk=64)
    chunked = TE._candidate_scores(tc, ts, h, r, t, cand, "tail", q_chunk=3)
    assert full.shape == chunked.shape == (10, 50)
    torch.testing.assert_close(chunked, full, rtol=1e-6, atol=1e-7)
    deg = kg.degrees().astype(np.float64) + 1
    r1, r2 = (TE.ranks_protocol2(tc, ts, test, deg, n_uniform=20, n_degree=20,
                                 rng=np.random.default_rng(1), q_chunk=q)
              for q in (64, 4))
    np.testing.assert_array_equal(r1, r2)


def test_metrics_and_filter_map_equal_jax(kg):
    ranks = np.random.default_rng(4).integers(1, 500, 257)
    assert TE.metrics_from_ranks(ranks).row() == JE.metrics_from_ranks(ranks).row()
    assert str(TE.metrics_from_ranks(ranks)) == str(JE.metrics_from_ranks(ranks))
    assert TE.build_filter_map(kg.triplets) == JE.build_filter_map(kg.triplets)
