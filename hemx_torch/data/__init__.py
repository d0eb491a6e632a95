"""Data sources, splits and the device-resident pipeline (counterpart of
``hemx.data``); only the synthetic dataset so far."""
