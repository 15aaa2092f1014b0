from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_batched, ssd_ref

__all__ = ["ssd_scan", "ssd_chunked", "ssd_chunked_batched", "ssd_ref"]
