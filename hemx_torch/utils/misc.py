"""Misc utilities (copy of ``hemx.utils.misc``): ``chunks``, ``fold``
(batched evaluation, the remainder dropped) and ``visualize_parameters``
(hemx's parameter table of a port network)."""

from __future__ import annotations

import numpy as np
import torch.nn as nn

from hemx_torch.convert import flatten_tree, to_jax


def chunks(lst, n: int):
    """Yield successive n-sized chunks."""
    for i in range(0, len(lst), n):
        yield lst[i:i + n]


def fold(fn, arrays, batch_size: int):
    """Apply ``fn`` over ``arrays`` in batches and average scalar results.
    ``arrays`` is a dict of equal-length numpy arrays; ``fn(batch_dict) ->
    float``. The remainder that does not fill a batch is dropped."""
    n = len(next(iter(arrays.values())))
    if n < batch_size:
        raise ValueError(
            f"fold: {n} rows is smaller than one batch ({batch_size}) — "
            f"averaging zero batches would silently report 0.0")
    total = 0.0
    count = 0
    for i in range(0, n - batch_size + 1, batch_size):
        batch = {k: v[i:i + batch_size] for k, v in arrays.items()}
        total += float(fn(batch))
        count += 1
    return total / count


def visualize_parameters(params) -> str:
    """Parameter table with totals: one row per leaf of hemx's parameter
    tree (path, hemx-layout shape, size), in hemx's order. ``params`` is a
    port network (read through ``hemx_torch.convert.to_jax``) or such a
    tree."""
    if isinstance(params, nn.Module):
        params = to_jax(params)[0]
    rows = []
    total = 0
    for path, leaf in sorted(flatten_tree(params).items()):
        shape = tuple(np.shape(leaf))
        size = int(np.prod(shape)) if shape else 1
        total += size
        rows.append(f"{'/'.join(path):<60s} {str(shape):<20s} {size:>12,d}")
    rows.append("-" * 94)
    rows.append(f"{'total':<60s} {'':<20s} {total:>12,d}")
    return "\n".join(rows)
