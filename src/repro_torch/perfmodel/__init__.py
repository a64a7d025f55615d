"""Performance model: cost counting of a PyTorch callable + roofline.

Port of ``repro.perfmodel``; its HLO collective parser waits for the
port's dry-run tooling."""
from .costs import CompiledCosts, extract_costs
from .hlo import CollectiveStats
from .roofline import RooflineTerms, roofline, roofline_across

__all__ = ["CollectiveStats", "CompiledCosts", "RooflineTerms", "extract_costs", "roofline",
           "roofline_across"]
