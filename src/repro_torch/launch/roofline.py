"""Roofline terms from a counted dry run: the twin of the JAX package's
launch/roofline.py, on the port's card (``common/hw.py`` ``H100_SXM``).

    compute    = FLOPs / peak bf16 FLOP/s   (as the reference divides by
                 its chip's bf16 peak, whatever the dtype)
    memory     = HBM bytes / HBM bandwidth
    collective = link bytes / the rate of the slowest link each group
                 crosses: NVLink within one node (at most ``nvlink_domain``
                 = 8 cards), the network between nodes (one 400 Gb/s
                 ConnectX-7 a GPU, NVIDIA's DGX H100 data sheet). A ring of
                 256 ranks does not run at NVLink's rate.

FLOPs, bytes and collective bytes are one rank's, from
``launch/hlo_analysis.py`` (``trace``). These terms are modelled from the
data sheet's rates, not measured: a figure read from them is a roofline,
not a time on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.common.hw import H100_SXM, HwSpec
from repro_torch.launch.hlo_analysis import HloCost, Trace


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities
    flops: float
    hbm_bytes: float
    coll_bytes: float
    collectives: Dict[str, Dict[str, float]]
    # seconds
    compute_s: float
    memory_s: float
    collective_s: float
    # accounting
    model_flops: float  # 6·N_active·D (global)
    useful_ratio: float  # MODEL_FLOPS / (flops × chips)
    # memory
    bytes_per_device: Optional[float] = None
    argument_bytes: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The largest term (the terms are also reported apart)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "bytes_per_device": self.bytes_per_device,
            "collectives": self.collectives,
        }


def roofline_from_cost(
    traced: Trace,
    arch: str,
    shape_name: str,
    mesh_name: str,
    chips: int,
    model_flops: float,
    hw: HwSpec = H100_SXM,
    hlo_cost: Optional[HloCost] = None,
) -> Roofline:
    """The reference's ``roofline_from_compiled`` with ``traced`` (what
    ``hlo_analysis.trace`` counted) where it takes the compiled program."""
    cost = hlo_cost or traced.cost
    cross = traced.mode.cross_node_bytes
    flops_global = cost.flops * chips
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops=cost.flops,
        hbm_bytes=cost.hbm_bytes,
        coll_bytes=cost.coll_bytes,
        collectives={
            k: {"count": c.count, "ici_bytes": c.bytes, "shard_bytes": c.raw_bytes}
            for k, c in cost.collectives.items()
        },
        compute_s=cost.flops / hw.peak_bf16_flops,
        memory_s=cost.hbm_bytes / hw.hbm_bandwidth,
        collective_s=(cross / hw.network_bandwidth
                      + (cost.coll_bytes - cross) / hw.nvlink_bandwidth),
        model_flops=model_flops,
        useful_ratio=model_flops / flops_global if flops_global else 0.0,
        bytes_per_device=float(traced.bytes_per_device),
        argument_bytes=float(traced.argument_bytes),
    )


def format_row(r: Roofline) -> str:
    gb = (r.bytes_per_device or 0) / 2**30
    return (
        f"{r.arch:24s} {r.shape:12s} {r.mesh:9s} "
        f"cmp {r.compute_s*1e3:9.3f}ms mem {r.memory_s*1e3:9.3f}ms "
        f"coll {r.collective_s*1e3:9.3f}ms -> {r.dominant:10s} "
        f"useful {r.useful_ratio:6.1%} {gb:6.2f}GiB/dev"
    )
