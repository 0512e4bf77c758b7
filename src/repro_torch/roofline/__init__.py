"""Roofline analysis of the port's steps on the card's constants."""
from repro_torch.roofline.hw import CHIP, HBM_BW, ICI_BW, LINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
from repro_torch.roofline.analysis import (
    CollectiveStats,
    RooflineTerms,
    model_flops,
    parse_collectives,
    roofline_terms,
    step_costs,
)

__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "HBM_BW", "LINK_BW", "ICI_BW", "CHIP",
           "parse_collectives", "roofline_terms", "model_flops", "RooflineTerms",
           "CollectiveStats", "step_costs"]
