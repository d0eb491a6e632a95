"""Optimizer factory and training loop (counterpart of ``hemx.train``)."""
