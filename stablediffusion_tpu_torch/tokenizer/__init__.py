"""CLIP BPE tokenizer."""
