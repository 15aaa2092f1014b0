"""The KGE training configuration (a copy of ``KGEConfig`` from the JAX
package's common/config.py: same fields, same defaults)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KGEConfig:
    """Configuration for the paper's KGE training core."""

    name: str = "kge"
    model: str = "transe_l2"  # transe_l1 transe_l2 transr distmult complex rescal rotate
    n_entities: int = 14_951
    n_relations: int = 1_345
    dim: int = 400
    # TransR / RESCAL relation-projection dim
    rel_dim: int = 0  # 0 => dim

    # loss
    loss: str = "logistic"  # logistic | ranking
    gamma: float = 12.0  # margin (ranking) / RotatE self-adversarial scale
    regularization: float = 2e-6

    # mini-batch / negative sampling (paper T1/T2)
    batch_size: int = 1024
    neg_sample_size: int = 256  # k
    neg_group_size: int = 0  # g; 0 => = batch_size (paper: g up to b)
    neg_deg_ratio: float = 0.5  # fraction of degree-based (in-batch) negatives
    corrupt_both: bool = True  # corrupt head and tail

    # distribution (paper T3/T4/T6)
    n_parts: int = 16  # graph partitions == data-axis size
    remote_capacity: int = 256  # R: max remote entity rows pulled per step
    rel_parts: int = 16  # relation partitions == compute units
    partitioner: str = "metis"  # metis | random
    overlap_update: bool = True  # paper T5: deferred entity update

    # optimizer (DGL-KE uses sparse Adagrad)
    lr: float = 0.1
    optimizer: str = "sparse_adagrad"

    dtype: str = "float32"
    comm_dtype: str = "float32"  # KVStore wire format

    def __post_init__(self):
        if self.rel_dim == 0:
            object.__setattr__(self, "rel_dim", self.dim)
        if self.neg_group_size == 0:
            object.__setattr__(self, "neg_group_size", self.batch_size)

    @property
    def n_neg_groups(self) -> int:
        return max(1, self.batch_size // self.neg_group_size)

    def batch_bytes_naive(self) -> int:
        """O(b*d*(k+1)) words — independent corruption (paper §3)."""
        return 4 * self.batch_size * self.dim * (self.neg_sample_size + 1)

    def batch_bytes_joint(self) -> int:
        """O(b*d + b*k*d/g) words — joint negative sampling (paper §3.3)."""
        b, d, k, g = self.batch_size, self.dim, self.neg_sample_size, self.neg_group_size
        return 4 * (3 * b * d + (b // g) * k * d)
