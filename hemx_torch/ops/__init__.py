"""Layers, activations, losses, initializers and the hand-written input
kernel (counterpart of ``hemx.ops``)."""
