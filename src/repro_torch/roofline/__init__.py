"""Port of ``repro.roofline``: the dry-run's roofline terms and the op walk
that counts a step (``op_walk``, the counterpart of ``hlo_walk``)."""

from repro_torch.roofline.analysis import (
    HW_H100, HW_V5E, collective_bytes_from_hlo, roofline_terms, RooflineReport,
)
from repro_torch.roofline.op_walk import aggregate, collective_schedule

__all__ = ["HW_H100", "HW_V5E", "collective_bytes_from_hlo", "roofline_terms",
           "RooflineReport", "aggregate", "collective_schedule"]
