"""Paper Table 3 dataset configs (synthetic structure-matched stand-ins);
the same values as the JAX package's configs/kge_datasets.py."""

from repro_torch.common.config import KGEConfig

FB15K = KGEConfig(
    name="fb15k", model="transe_l2", n_entities=14_951, n_relations=1_345,
    dim=400, gamma=19.9, batch_size=1024, neg_sample_size=256, lr=0.25,
    n_parts=16, remote_capacity=2048,
)

WN18 = KGEConfig(
    name="wn18", model="transe_l2", n_entities=40_943, n_relations=18,
    dim=512, gamma=6.0, batch_size=1024, neg_sample_size=128, lr=0.1,
    n_parts=16, remote_capacity=2048,
)

FREEBASE = KGEConfig(
    name="freebase", model="transe_l2", n_entities=86_054_151,
    n_relations=14_824, dim=400, gamma=10.0, batch_size=1024,
    neg_sample_size=256, neg_deg_ratio=0.5, lr=0.1,
    n_parts=16, remote_capacity=4096,
)
