"""How ``correct`` is decided for a training cell.

Set-up drives the program's train state through its first
:data:`hxbench.data.COMPARED` calls, through the program's own train call
and feeder, with the noise of each call handed in through the program's
noise seam; the window then continues with that same state. The plain
reference follows those calls from the same initial tensors, rows and
noise, after the window, and four numbers are compared, each against the
limit in ``hxbench/limits/<cell>.json``:

* ``loss``: the largest gap between a loss the program reported for the
  first call and the reference's, as a share of the larger of the
  reference's value and the median of its values;
* ``grad``: over the leaves, the median gap between the norms of a leaf's
  first moment in the optimizer after the first call (for a network
  stepped once a call, ``(1 - beta1)`` times its first gradient), each as
  a share of the larger of the reference's norm of that leaf and of the
  median leaf;
* ``change``: the same median of the norms of each leaf's change over the
  compared calls, leaving out the leaves whose first moment in the
  reference is under a thousandth of the median leaf's (nought to
  rounding: Adam moves them by round-off alone);
* ``change_max``: the largest of those gaps, which a leaf left unmoved or
  moved twice (a gap of 1) fails.

The first call's loss and the median leaf stand where the worst leaf and
all three calls' losses were first compared: on the card those swung with
one small leaf's rounding (a three-element bias) and with the GAN's
divergence by the third call, and separated no fault (PERF.md).

Readings are ``{"losses": [{name: value}] per call, "moment": {leaf:
norm}, "change": {leaf: norm}}``.
"""

from __future__ import annotations

import statistics

import torch

from hxbench import data
from hxbench.reference import plain

NUMBERS = ("loss", "grad", "change", "change_max")
#: a leaf whose reference moment is under this share of the median leaf's
#: is left out of ``change``
NOUGHT = 1e-3


def norms(tensors: dict) -> dict:
    """``{name: float norm}``, in one copy to the host."""
    names = sorted(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].detach().float().norm() for k in names])
    return dict(zip(names, vals.cpu().tolist()))


def _gaps(prog: dict, ref: dict) -> list:
    """Each ``ref`` key's gap, as a share of the larger of its reference
    value and the median reference value."""
    floor = statistics.median(abs(v) for v in ref.values())
    return [abs(prog[k] - ref[k]) / max(abs(ref[k]), floor, 1e-30)
            for k in ref]


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers of two readings (``prog`` the program's or a
    control's, ``ref`` the reference's)."""
    first = {k: v for k, v in ref["losses"][0].items()
             if k in prog["losses"][0]}
    floor = statistics.median(ref["moment"].values())
    moved = {k: v for k, v in ref["change"].items()
             if ref["moment"][k] >= NOUGHT * floor}
    change = _gaps(prog["change"], moved)
    return {"loss": max(_gaps(prog["losses"][0], first)),
            "grad": statistics.median(_gaps(prog["moment"], ref["moment"])),
            "change": statistics.median(change),
            "change_max": max(change)}


def verdict(nums: dict, limits: dict) -> bool:
    """Every number within its limit; a limit of None compares nothing
    (a number with no reading that fails to set it from)."""
    return all(limits[k] is None or nums[k] <= limits[k] for k in NUMBERS)


def reference(cell: dict, seed: int, device, *, round=None,
              fault: str | None = None, rows_of: int = 1) -> dict:
    """The reference's readings of the compared calls of ``cell`` at the
    global batch, in the precision the configuration states. ``round``: a
    rounding of every product's operands and the gradients they pass back
    (the control). ``fault``: ``"half"``, the second
    half of every batch replaced by its first (the mean taken over half the
    rows); ``"alone"``, each step on the first ``1 / rows_of`` of the
    global batch and its noise (a rank whose exchange with the others is
    left out)."""
    from hxbench import spec
    cfg, traffic = cell["config"], cell["traffic"]
    ref = spec.module("reference", cfg["name"], cell["here"])
    specs = ref.specs(cfg)
    gb = data.global_batch(traffic)
    per_call = len(ref.noise_spec(cfg, gb))
    u8 = data.rows(cfg, traffic, seed, device)
    params = plain.init_state(specs, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    opt = plain.optimizers(cfg, specs, params)
    keep = gb // rows_of if fault == "alone" else gb
    out = {"losses": []}
    prec = plain.precision(cfg, round)
    with plain.tf32(prec.tf32):
        for call in range(data.COMPARED):
            idx = data.call_indices(seed, traffic, per_call, call)
            batches = []
            for rows in idx:
                rows = torch.as_tensor(rows[:keep], device=device)
                if fault == "half":
                    rows = torch.cat([rows[:keep // 2]] * 2)
                batches.append({k: plain.normalize_u8(v.index_select(0, rows))
                                for k, v in u8.items()})
            nz = [{k: v[:keep] for k, v in step.items()} for step in
                  data.noise(ref.noise_spec(cfg, gb), seed, call, device)]
            out["losses"].append(ref.train_call(params, opt, batches, nz,
                                                prec))
            if call == 0:
                out["moment"] = norms({k: m for o in opt.values()
                                       for k, m in o.mu.items()})
    out["change"] = norms({k: params[k].detach() - start[k]
                           for o in opt.values() for k in o.mu})
    return out
