"""The benchmark's frozen copies equal the port's originals today: the cost
formulas at the cells' shapes, the data-sheet rates, the graph generator
and the joint sampler."""

import json

import numpy as np
import pytest

from _tiny import ROOT

from kgebench import graph, sampler
from kgebench.cost import peaks
from kgebench.cost.dedup_aggregate import dedup_cost
from kgebench.cost.fused_update import update_cost
from kgebench.cost.pairwise import pairwise_cost
from kgebench.cost.rescal_proj import rescal_proj_cost
from repro_torch.common.config import KGEConfig
from repro_torch.common.hw import H100_SXM
from repro_torch.core.sampling import JointSampler
from repro_torch.data.kg_synth import make_synthetic_kg
from repro_torch.kernels.kge_score import cost as score_cost
from repro_torch.kernels.rescal_proj import cost as rescal_cost
from repro_torch.kernels.sparse_adagrad import cost as adagrad_cost


def _same(a, b):
    assert (a.name, a.flops, a.bytes, a.unit, tuple(a.more)) == (
        b.name, b.flops, b.bytes, b.unit, tuple(b.more))


@pytest.mark.parametrize("mode", ["dot", "l2sq", "l1"])
@pytest.mark.parametrize("shape", [(4, 256, 256, 500), (1, 512, 14951, 400), (4, 8, 8, 16)])
def test_pairwise_cost(mode, shape):
    _same(pairwise_cost(mode, *shape), score_cost.pairwise_cost(mode, *shape))


@pytest.mark.parametrize("n,D,valid", [(4096, 500, 3700), (1024, 200, 344),
                                       (1024, 250000, 370), (1024, 40000, None)])
def test_adagrad_costs(n, D, valid):
    _same(dedup_cost(n, D), adagrad_cost.dedup_cost(n, D))
    _same(update_cost(n, D, valid), adagrad_cost.update_cost(n, D, valid))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(1024, 500, 500), (64, 203, 300)])
def test_rescal_proj_cost(shape, backward):
    _same(rescal_proj_cost(*shape, backward), rescal_cost.rescal_proj_cost(*shape, backward))


def test_peaks_are_the_data_sheet():
    p = peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == H100_SXM.hbm_bandwidth
    assert p["fp32"] == H100_SXM.peak_fp32_flops
    assert p["tf32"] == H100_SXM.peak_tf32_flops
    assert p["tf32x3"] == pytest.approx(H100_SXM.peak_tf32_flops / 3, rel=1e-3)
    assert p["bf16"] == H100_SXM.peak_bf16_flops


def test_graph_and_sampler_copies():
    params = dict(n_entities=500, n_relations=20, n_edges=8000, n_clusters=5, seed=3)
    kg = make_synthetic_kg(**params)
    train = graph.make_train_triplets(**params)
    np.testing.assert_array_equal(train, kg.train)
    conf = json.loads((ROOT / "kgebench/configs/rescal-fb15k.json").read_text())
    assert set(conf["dataset"]) >= set(params)
    cfg = KGEConfig(n_entities=500, n_relations=20, batch_size=64, neg_sample_size=16,
                    neg_group_size=32, neg_deg_ratio=0.5)
    port = JointSampler(train, 500, cfg, np.random.default_rng(2**33 + 1))
    ours = sampler.JointSampler(train, 500, 64, 16, cfg.n_neg_groups, 0.5,
                                np.random.default_rng(2**33 + 1))
    for _ in range(3):
        a, b = port.sample(), ours.sample()
        for f in ("h", "r", "t", "neg"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
