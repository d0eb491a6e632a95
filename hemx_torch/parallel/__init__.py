"""Data parallelism (counterpart of ``hemx.parallel``): the process group
that stands for hemx's ``data`` mesh axis (``mesh``) and the collectives
that give every batch-level quantity hemx's global-batch value (``dp``)."""
