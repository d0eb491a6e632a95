"""Multiply-adds of one sample through the layers the configurations use,
from their shapes alone. A convolution's are those of its output (each
output element: kernel area times input channels); a transposed
convolution's are those of its input (each input element reaches kernel
area times output channels), so neither counts the zeros an implementation
may insert or pad. Two FLOPs per multiply-add."""

from __future__ import annotations

import math


def conv_macs(out_hw: int, k: int, cin: int, cout: int) -> int:
    """A ``k`` x ``k`` convolution to ``out_hw`` x ``out_hw``."""
    return out_hw * out_hw * k * k * cin * cout


def deconv_macs(in_hw: int, k: int, cin: int, cout: int) -> int:
    """A ``k`` x ``k`` transposed convolution from ``in_hw`` x ``in_hw``."""
    return in_hw * in_hw * k * k * cin * cout


def dense_macs(cin: int, cout: int) -> int:
    return cin * cout


def same_out(n: int, stride: int) -> int:
    return math.ceil(n / stride)
