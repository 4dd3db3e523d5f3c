"""Kernel wrappers with their plain PyTorch versions, tapes and packing."""
