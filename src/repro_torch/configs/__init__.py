"""Config registry: ``get_arch(name)`` / ``ARCHS`` for the LM zoo, plus the
paper's own KGE dataset configs. The same entries as the JAX package's
``configs/__init__.py``; the model refuses the kinds the port does not run
yet (``models/transformer.build_model``), the registry does not."""

from repro_torch.configs.dbrx_132b import CONFIG as dbrx_132b
from repro_torch.configs.h2o_danube_1_8b import CONFIG as h2o_danube_1_8b
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as jamba_1_5_large_398b
from repro_torch.configs.kge_datasets import FB15K, FREEBASE, WN18
from repro_torch.configs.llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from repro_torch.configs.mamba2_2_7b import CONFIG as mamba2_2_7b
from repro_torch.configs.minicpm3_4b import CONFIG as minicpm3_4b
from repro_torch.configs.minitron_4b import CONFIG as minitron_4b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.qwen1_5_0_5b import CONFIG as qwen1_5_0_5b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3

ARCHS = {
    "minitron-4b": minitron_4b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "mixtral-8x7b": mixtral_8x7b,
    "whisper-large-v3": whisper_large_v3,
    "minicpm3-4b": minicpm3_4b,
    "dbrx-132b": dbrx_132b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "mamba2-2.7b": mamba2_2_7b,
}

KGE_DATASETS = {"fb15k": FB15K, "wn18": WN18, "freebase": FREEBASE}


def get_arch(name: str):
    return ARCHS[name]
