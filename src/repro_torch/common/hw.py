"""Target-hardware constants of the port: one NVIDIA H100 SXM.

The twin of the JAX package's common/hw.py (whose ``TPU_V5E`` is the TPU's).
Every number is the dense rate or size of NVIDIA's H100 SXM data sheet, at
the card's full 700 W power limit; a card set below it (``nvidia-smi
--query-gpu=power.limit``) runs slower under load. ``chip_smoke.py`` reads
its bounds (the least time the card could take for a kernel's work) from
``H100_SXM``; a roofline over the port's programs would read the same spec.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_bf16_flops: float  # FLOP/s per card, dense bf16 tensor cores
    peak_tf32_flops: float  # FLOP/s per card, dense TF32 tensor cores
    peak_fp32_flops: float  # FLOP/s per card, fp32 outside the tensor cores
    hbm_bandwidth: float  # bytes/s per card
    nvlink_bandwidth: float  # bytes/s per card, per direction, all links
    hbm_bytes: int  # HBM capacity per card
    smem_bytes: int  # shared memory per SM (L1 and shared, configurable)
    sm_count: int


# Sources: NVIDIA H100 Tensor Core GPU data sheet, SXM column (dense rates,
# without sparsity): bf16 989 TFLOP/s, TF32 494.7 (989.4 with sparsity), fp32
# 67, HBM3 3.35 TB/s and 80 GB, NVLink 900 GB/s (both directions). The SM
# count and the shared memory per SM are the H100 SXM5's in NVIDIA's Hopper
# architecture whitepaper (and compute capability 9.0's in the CUDA C++
# programming guide).
H100_SXM = HwSpec(
    name="nvidia-h100-sxm",
    peak_bf16_flops=989e12,
    peak_tf32_flops=494.7e12,
    peak_fp32_flops=67e12,
    hbm_bandwidth=3.35e12,
    nvlink_bandwidth=450e9,  # 900 GB/s over 18 links, both directions
    hbm_bytes=80 * 1024**3,  # "80 GB", counted as the reference counts v5e's
    smem_bytes=228 * 1024,
    sm_count=132,
)
