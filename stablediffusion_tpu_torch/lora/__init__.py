"""LoRA factors over the port's linear modules."""
