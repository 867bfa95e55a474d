from repro_torch.kernels.ssd.ops import ssd, ssd_chunk_scan
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref

__all__ = ["ssd", "ssd_chunk_scan", "ssd_chunked_ref", "ssd_ref"]
