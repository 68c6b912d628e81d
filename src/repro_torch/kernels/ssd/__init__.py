from .ops import SSD_INTRA, ssd_intra, ssd_scan
from .ref import ssd_intra_ref

__all__ = ["SSD_INTRA", "ssd_intra", "ssd_scan", "ssd_intra_ref"]
