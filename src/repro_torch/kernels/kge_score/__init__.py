from repro_torch.kernels.kge_score.ops import pairwise_kernel, pairwise_scores
from repro_torch.kernels.kge_score.ref import pairwise_ref
