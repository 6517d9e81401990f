"""Compute ops: the attention dispatcher and its plain PyTorch version."""
