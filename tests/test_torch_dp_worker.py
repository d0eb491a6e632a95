"""Worker side of the data-parallel tests: one train call of the port's
model in a process group, from a start checkpoint, on the rows of global
batches and noise this rank owns (under ``model_parallel`` or
``spatial_parallel`` in the spec's flags, hemx's grid of them: its rows,
its band of each image for a model that runs on bands, and its slice of
each kernel).

The spawned workers import torch, numpy and hemx_torch only (never JAX or
hemx), so this module imports nothing else; its one test checks the
spec's array naming. A spec (JSON) names
the model's flags, the input shape, the start checkpoint's directory, an
``.npz`` of the global batches (``batch<i>/<key>``, NHWC) and, optionally,
of the global noise the seam hands in (``noise<i>/<key>``, NCHW), and the
output directory, where rank 0 writes ``checkpoint-1.msgpack`` and
``metrics.json`` (the metrics reduced over the ranks), and under a model
axis every rank ``shards-<rank>.npz``: its own slices of the train state
in hemx layout, keyed by tree path.
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import torch


def _groups(arrays, prefix: str) -> list:
    out: dict = {}
    for name in arrays.files:
        head, key = name.split("/", 1)
        if head.startswith(prefix):
            out.setdefault(int(head[len(prefix):]), {})[key] = arrays[name]
    return [out[i] for i in sorted(out)]


def one_call(spec_path: str) -> None:
    from hemx_torch import convert
    from hemx_torch.models import common
    from hemx_torch.models.plugin import get_model
    from hemx_torch.parallel import dp, mesh
    from hemx_torch.train.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    args = types.SimpleNamespace(**spec["args"])
    mesh.make_axes(getattr(args, "model_parallel", 1),
                   getattr(args, "spatial_parallel", 1))
    model = get_model(args.model)(args, "cpu")
    ts = model.init_state(tuple(spec["image_shape"]), args.seed)
    convert.load_checkpoint(ts, CheckpointManager(spec["start"]).restore())
    arrays = np.load(spec["arrays"])
    batches = [{k: torch.from_numpy(np.ascontiguousarray(dp.host_slice(
        v, bands=model.band_input))).permute(0, 3, 1, 2)
        for k, v in b.items()} for b in _groups(arrays, "batch")]
    noise = [{k: torch.from_numpy(v) for k, v in n.items()}
             for n in _groups(arrays, "noise")]
    kw = {"noise": noise} if noise else {}
    ts, metrics = model.train(ts, iter(batches), **kw)
    metrics = common.host_scalars(dp.reduce_metrics(metrics))
    CheckpointManager(spec["out"]).save(convert.to_checkpoint(ts, 1), 1)
    if dp.axis_kind() == "model":
        with dp.local():  # this rank's slices, not the gathered kernels
            mine = convert.flatten_tree(convert.train_state_to_jax(ts))
        np.savez(os.path.join(spec["out"], f"shards-{dp.rank()}.npz"),
                 **{"/".join(k): v for k, v in mine.items()})
    if dp.is_primary():
        with open(os.path.join(spec["out"], "metrics.json"), "w") as f:
            json.dump(metrics, f)


def calls(spec_paths: list) -> None:
    """:func:`one_call` of each spec in turn, in one process group (its
    ranks started once for all of them)."""
    for path in spec_paths:
        one_call(path)


def test_groups_orders_substeps_by_index():
    arrays = _Arrays({"batch10/image": 0, "batch2/image": 1,
                      "batch2/depth": 2, "noise0/z": 3})
    assert _groups(arrays, "batch") == [{"image": 1, "depth": 2},
                                        {"image": 0}]
    assert _groups(arrays, "noise") == [{"z": 3}]


class _Arrays(dict):
    """An ``np.load`` result's interface: ``files`` and item access."""

    @property
    def files(self):
        return list(self)
