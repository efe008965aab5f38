"""Fleet: so far only activation recomputation (the rest of the fleet
API waits for ROADMAP queue A9)."""
from .recompute import recompute

__all__ = ["recompute"]
