"""Performance model: cost counting of a PyTorch callable, collective
accounting (HLO text, or the calls one rank made) + roofline.  Port of
``repro.perfmodel``."""
from .costs import CompiledCosts, extract_costs
from .hlo import CollectiveStats, collective_bytes, recorded_stats
from .roofline import RooflineTerms, roofline, roofline_across

__all__ = ["CollectiveStats", "CompiledCosts", "RooflineTerms", "collective_bytes",
           "extract_costs", "recorded_stats", "roofline", "roofline_across"]
