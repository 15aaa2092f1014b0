"""The paper's KGE dataset configs."""

from repro_torch.configs.kge_datasets import FB15K, FREEBASE, WN18

KGE_DATASETS = {"fb15k": FB15K, "wn18": WN18, "freebase": FREEBASE}
