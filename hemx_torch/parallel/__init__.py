"""Parallelism (counterpart of ``hemx.parallel``): the process group and
hemx's grid of mesh axes over it (``mesh``), the collectives that give
every batch-level quantity hemx's global-batch value (``dp``), and the
layers of the ``model`` axis (``tp``: kernels sliced over ranks) and the
``spatial`` axis (``sp``: image height banded over ranks)."""
