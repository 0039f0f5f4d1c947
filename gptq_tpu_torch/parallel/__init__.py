"""Parallel serving on torch.distributed (sequence parallelism: sp.py)."""
