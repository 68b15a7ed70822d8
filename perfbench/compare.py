"""The numbers that decide ``correct``, each held to its limit.

A training cell's outputs, from the program or from the plain reference,
are one dict: ``losses`` (per learner step or train phase, ``(critic,
actor)``), ``moment`` (the norm of each leaf's Adam first moment after the
first step or phase: the first gradients as the optimizer got them),
``change`` (the norm of each leaf's change over the compared steps, for
the online and the target nets), ``priority`` (the arena's priority vector
after the first step or phase; the reference adds ``exact_priority``, the
same vector with every value written recomputed in float64), ``misses``
(program indices the reference's draw does not bear out) and, for the
train cell, ``seqs`` (the sequences it added).
A gap of norms is taken leaf by leaf, ``| |p| - |r| |``, against the
reference's norm of that leaf or of the median leaf of its net, whichever
is larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's (round-off alone moves them under Adam) are left out of the
change.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

NOUGHT = 1e-3  # a leaf's gradient under this share of the median's is rounding


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> List[float]:
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def training_checks(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``{number: value}`` for a training cell: each step's two losses (see
    ``_loss_gaps``), the first step's alone (``first_loss_gap``, which the
    forward pass decides before any update: where the backward pass is not
    repeatable, as cuDNN's convolutions are not, Adam's first update turns
    its rounding into whole ``lr`` moves of near-nought elements, and the
    later steps' losses swing from run to run with it), the worst leaf's
    first gradient, the median leaf's
    change over the compared steps, the priorities after the first step
    (against their float64 recomputation, so that a sound program reads its
    own rounding and not how far its order of sums differs from the
    reference's), the misses and the added sequences.

    The change is the median leaf's and not the worst's: Adam's first
    updates are ``lr * g / (|g| + eps)``, so an element whose first gradient
    is nought to rounding (a ReLU at its threshold, a sum that cancels)
    moves by a full ``lr`` on one side and not on the other, and in a small
    leaf, as the first convolution of the pixel torso, that swings the
    worst leaf's gap from seed to seed (``wide_checks`` keeps it)."""
    out: Dict[str, float] = {}
    gaps = _loss_gaps(prog["losses"], ref["losses"])
    out["loss_gap"] = max(max(g) for g in gaps)
    out["first_loss_gap"] = max(gaps[0])
    out["grad_gap"] = max(max(_leaf_gaps(prog["moment"][net], ref["moment"][net]))
                          for net in ref["moment"])
    out["change_gap"] = statistics.median(_change_gaps(prog, ref))
    pp, pr = prog["priority"].double(), ref["exact_priority"].double()
    out["prio_gap"] = float(((pp - pr).abs() / pr.abs().clamp_min(1e-12)).max())
    out["index_misses"] = float(ref.get("misses", 0))
    if "seqs" in ref:
        out["seq_gap"] = max(float((a.double() - b.double()).abs().max())
                             for a, b in zip(prog["seqs"], ref["seqs"]))
    return out


def _loss_gaps(prog: List, ref: List) -> List[List[float]]:
    """Each step's gaps of its losses, ``|p - r|``, against the reference's
    value or the median of that loss over the compared steps, whichever is
    larger: the actor loss ``-mean Q`` crosses zero, where its relative gap
    would stand for nothing but rounding over a near-zero value."""
    scales = [statistics.median(abs(r[j]) for r in ref) for j in range(len(ref[0]))]
    return [[abs(pj - rj) / max(abs(rj), sj, 1e-12) for pj, rj, sj in zip(p, r, scales)]
            for p, r in zip(prog, ref)]


def _change_gaps(prog: Dict, ref: Dict) -> List[float]:
    """Each compared leaf's gap of change norms; a leaf whose reference
    gradient is nought to rounding is left out."""
    gaps: List[float] = []
    for group, leaves in ref["change"].items():
        grads = ref["moment"][group.replace("target_", "")]
        med = statistics.median(grads.values())
        keep = {k for k, g in grads.items() if g >= NOUGHT * med}
        gaps += _leaf_gaps(prog["change"][group], leaves, keep)
    return gaps


def wide_checks(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The worst leaf's change, which the median leaf's stands in for
    (``control.py`` reports both)."""
    return {"worst_change_gap": max(_change_gaps(prog, ref))}


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tree)
    vals = torch.stack([tree[k].double().norm() for k in keys]).tolist()
    return dict(zip(keys, vals))


def change_norms(after: Dict[str, Dict[str, torch.Tensor]],
                 before: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, float]]:
    return {g: norms({k: after[g][k] - before[g.replace("target_", "")][k] for k in after[g]})
            for g in after}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """One entry per number that the cell's limits name: its value, its
    limit and whether it holds.  A named number the run did not give does
    not hold (value ``None``); a number with no limit is not judged."""
    out = []
    for k in sorted(limits):
        v = values.get(k)
        out.append({"name": k, "value": v, "limit": limits[k],
                    "ok": v is not None and v <= limits[k]})
    return out


def serving_checks(served, reference, mask) -> Dict[str, float]:
    """``action_gap``: the largest gap between a served action and the
    plain rollout's, over every answered request compared."""
    gap = abs(served.astype("float64") - reference.astype("float64")).max(axis=-1)
    return {"action_gap": float(gap[mask].max()) if mask.any() else float("inf")}
