from repro_torch.kernels.sparse_adagrad.ops import dedup_aggregate, fused_sparse_adagrad
from repro_torch.kernels.sparse_adagrad.ref import dedup_aggregate_ref, fused_update_ref
