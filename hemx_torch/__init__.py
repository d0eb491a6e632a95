"""hemx_torch — the PyTorch / CUDA port of hemx for NVIDIA Hopper (H100).

The JAX package ``hemx`` is the reference; every module here mirrors the
``hemx`` module of the same name and is held against it by the CPU tests
(``tests/test_torch_*.py``). The package imports ``torch`` and numpy only —
never ``jax``, ``flax``, ``optax``, ``msgpack``, ``hemx`` or Triton. Its one
CUDA kernel (``csrc/gather_u8_normalize.cu``) is compiled by nvcc at its
first launch on a CUDA tensor, so ``import hemx_torch`` works on a machine
without a GPU or a CUDA compiler.

Nothing is imported eagerly: import the submodule you need
(``hemx_torch.models.gan``, ``hemx_torch.cli``, ...).
"""

__version__ = "0.1.0"
