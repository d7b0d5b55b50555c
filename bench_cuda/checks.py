"""The numbers that decide ``correct``, each held against its limit.

Stream (``drivers.stream.compare``): the relative L2 gap of the program's
carried state from the reference's, and the gap of its forecast from the
reference's forecast out of the program's own state, in units of the
reference's own bfloat16 gap; each the worst over the compared requests.

Training: the reference follows each of the first three steps from the
program's own parameters and Adam state at that step, so no step's
rounding carries into the next compared step. Compared are each step's
loss, each step's gradient as the optimizer got it (``(m_{k+1} -
b1 * m_k) / (1 - b1)`` from Adam's first moment, clipped already), and the
change of the parameters over the three steps (the program's: ``p_3 -
p_0``; the reference's: the sum of its three updates, each from the
program's state). A leaf's gap is the gap between the two norms over the
larger of the reference's norm of that leaf and of the median leaf.
Gradients are compared by the worst leaf, and also by the norm of their
difference (``grad_diff_gap``), which sees a gradient that points
elsewhere while its norm stays alike. (On the seeded frames every row's
gradient points alike, so a batch reduced over half its rows is caught by
the loss, not by either gradient number; PERF.md, Open questions.) The change is compared by the median leaf
(``change_median_gap``): Adam moves an element by about lr * sign(g), so
where rounding flips the sign of a gradient element near zero, that
element's change differs by up to 2 lr, and the worst leaf's gap swings
from seed to seed with how many such elements a small leaf holds. A leaf
whose reference gradient is under a thousandth of the median leaf's is
left out of the change (its Adam update is round-off).
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Sequence

import torch

ADAM_B1 = 0.9
LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "limits")


def limits(cell: str) -> Dict[str, float]:
    """The cell's limits, ``limits/<cell>.json`` (set from the readings in
    PERF.md: the program's sound runs below, the control and the planted
    faults above)."""
    with open(os.path.join(LIMITS_DIR, f"{cell}.json")) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| over max(‖ref leaf‖, median ‖ref
    leaf‖)."""
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k]
                                                         for k in keys})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def leaf_gap(prog, ref, keys) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keys).values())


def leaf_diff(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Sequence[str]) -> float:
    """The worst leaf's ‖prog − ref‖ over max(‖ref leaf‖, median ‖ref
    leaf‖): unlike the gap of norms, it sees a gradient that points
    elsewhere."""
    rn = _norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    return max(float(torch.linalg.vector_norm(prog[k].double()
                                              - ref[k].double()))
               / max(rn[k], med, 1e-30) for k in keys)


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient norm reaches a thousandth of the
    median leaf's."""
    n = _norms(ref_grads)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= 1e-3 * med]


def program_grad(snaps: List[dict], k: int) -> Dict[str, torch.Tensor]:
    """Step k's gradient as Adam received it, from its first moments before
    and after the step."""
    before, after = snaps[k]["exp_avg"], snaps[k + 1]["exp_avg"]
    return {n: (after[n].double() - ADAM_B1 * before[n].double())
            / (1 - ADAM_B1) for n in after}


def train_readings(snaps: List[dict], losses: Sequence[float],
                   ref_steps: List[tuple], detail=None) -> Dict[str, float]:
    """The three training numbers. ``snaps[k]``: the program's params and
    Adam moments before step k (k = 0..3); ``losses[k]``: its loss at step
    k; ``ref_steps[k]``: the reference's (loss, clipped gradients, state
    after) for step k from ``snaps[k]``."""
    n = len(ref_steps)
    loss_gap = max(abs(losses[k] - ref_steps[k][0])
                   / max(abs(ref_steps[k][0]), 1e-30) for k in range(n))
    keys = list(ref_steps[0][1])
    grads = [program_grad(snaps, k) for k in range(n)]
    grad_gap = max(leaf_gap(grads[k], ref_steps[k][1], keys)
                   for k in range(n))
    grad_diff = max(leaf_diff(grads[k], ref_steps[k][1], keys)
                    for k in range(n))
    moving = moving_leaves(ref_steps[0][1])
    prog_change = {k: snaps[n]["params"][k].double()
                   - snaps[0]["params"][k].double() for k in moving}
    ref_change = {k: sum(ref_steps[s][2].params[k].double()
                         - snaps[s]["params"][k].double() for s in range(n))
                  for k in moving}
    change_gaps = leaf_gaps(prog_change, ref_change, moving)
    change_gap = statistics.median(change_gaps.values())
    if detail is not None:
        detail["change_by_leaf"] = change_gaps
        detail["grad_by_leaf"] = {
            k: max(leaf_gaps(grads[s], ref_steps[s][1], keys)[k]
                   for s in range(n)) for k in keys}
        detail["losses"] = [list(losses), [r[0] for r in ref_steps]]
    return {"loss_rel_gap": loss_gap, "grad_gap": grad_gap,
            "grad_diff_gap": grad_diff, "change_median_gap": change_gap}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    return all(readings.get(k) is not None and readings[k] == readings[k]
               and readings[k] <= lim for k, lim in limits.items())


def check_lines(readings: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, dict]:
    return {k: {"value": readings.get(k), "limit": lim}
            for k, lim in limits.items()}
