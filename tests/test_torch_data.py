"""The port's graph generator and samplers give the JAX package's numbers."""

import dataclasses

import numpy as np
import pytest

from repro.common.config import KGEConfig as JaxCfg
from repro.configs import KGE_DATASETS as JAX_DATASETS
from repro.core import sampling as jsamp
from repro.data import kg_synth as jsynth
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.configs import KGE_DATASETS as TORCH_DATASETS
from repro_torch.core import sampling as tsamp
from repro_torch.data import kg_synth as tsynth


def test_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxCfg)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TorchCfg)]
    assert jf == tf
    assert JaxCfg(batch_size=64, neg_group_size=16).n_neg_groups == \
        TorchCfg(batch_size=64, neg_group_size=16).n_neg_groups == 4


@pytest.mark.parametrize("name", ["fb15k", "wn18", "freebase"])
def test_dataset_configs_match(name):
    assert dataclasses.asdict(JAX_DATASETS[name]) == \
        dataclasses.asdict(TORCH_DATASETS[name])


@pytest.mark.parametrize("gen,scale", [("fb15k_like", 0.02), ("wn18_like", 0.01)])
def test_synthetic_graph_identical(gen, scale):
    a = getattr(jsynth, gen)(scale=scale, seed=3)
    b = getattr(tsynth, gen)(scale=scale, seed=3)
    for f in ("triplets", "train", "valid", "test", "cluster_of", "latent"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.degrees(), b.degrees())


def _cfg(cls):
    return cls(n_entities=300, n_relations=12, batch_size=32,
               neg_sample_size=8, neg_group_size=16)


@pytest.mark.parametrize("kind", ["JointSampler", "NaiveSampler"])
def test_sampler_streams_identical(kind):
    kg = jsynth.make_synthetic_kg(n_entities=300, n_relations=12, n_edges=2000,
                                  n_clusters=4, seed=0)
    sj = getattr(jsamp, kind)(kg.train, 300, _cfg(JaxCfg), np.random.default_rng(7))
    st = getattr(tsamp, kind)(kg.train, 300, _cfg(TorchCfg), np.random.default_rng(7))
    for _ in range(4):
        bj, bt = sj.sample(), st.sample()
        for f in ("h", "r", "t", "neg"):
            np.testing.assert_array_equal(getattr(bj, f), getattr(bt, f))
    if kind == "JointSampler":
        assert bt.neg.shape == (tsamp.MODES, 2, 8)
        assert tsamp.batch_distinct_entities(bt) == jsamp.batch_distinct_entities(bj)
