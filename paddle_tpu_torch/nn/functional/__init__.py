from .sampling import sample_logits_per_slot

__all__ = ["sample_logits_per_slot"]
