"""The numbers that decide ``correct``, and the limits they are held to.

Page cells (``page_numbers``) compare a sample of pages, each as the timed
path produced it, with the reference's outputs for the same page:

* ``mask_gap``, ``shrink_gap``: the mean absolute gap of the net's seg mask
  and of its DB shrink map (probabilities at letterbox resolution), the
  largest over the pages;
* ``det_gap``: the mean absolute gap of the Detect rows' confidence
  (objectness x best class) over the anchors where either side reads more
  than 0.1, the largest over the pages;
* ``box_gap``, ``quad_gap``: the mean over the final blocks (line quads)
  of both sides of 1 - the best IoU with one of the other side (of the
  same class; quads by their bounding boxes);
* ``raw_gap``, ``refined_gap``: 1 - IoU of the raw and of the refined
  masks, over the pages' pixels together.

The steps after the net (NMS, the raw mask, the DB decode, the grouping,
the refinement) are held apart (``stage_numbers``): the reference runs
them on the program's own net outputs, whose gap to the reference's net
the first three numbers hold, and the program's final outputs are compared
with what they give, as ``stage_box_gap``, ``stage_quad_gap``,
``stage_raw_gap`` and ``stage_refined_gap``.  A borderline block that
flips between bf16 and float32 nets thus shows in the net's gaps, and a
wrong block, line, raw or refined mask made after the net in the stages'.

The DB training cell (``train_numbers``) compares the losses of the
checked mini-steps, the first update's gradient and the parameters'
change over the checked updates, leaf by leaf (see ``train_numbers``).

A cell's limits are ``limits/<workload>.json``: the numbers it compares,
each with its limit and the readings it was set from; only those decide
``correct``.  The page cells hold the net's three gaps, ``raw_gap`` and
the four stage gaps; ``box_gap``, ``quad_gap`` and ``refined_gap`` of the
whole path are reported by ``tools/gap_probe.py`` but not held (PERF.md,
section 6).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}


def _iou(a, b) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def _shortfall(xs: Sequence, ys: Sequence, key=lambda v: v) -> float:
    """Sum over ``xs`` and ``ys`` of 1 - the best IoU with an entry of the
    same class on the other side (1 where there is none)."""
    def best(a, others):
        ka = key(a)
        return max((_iou(ka[0], key(b)[0]) for b in others if key(b)[1] == ka[1]), default=0.0)

    return sum(1.0 - best(x, ys) for x in xs) + sum(1.0 - best(y, xs) for y in ys)


def _quad_box(q) -> tuple:
    q = np.asarray(q).reshape(4, 2)
    return (q[:, 0].min(), q[:, 1].min(), q[:, 0].max(), q[:, 1].max()), 0


def _conf(blks: torch.Tensor) -> torch.Tensor:
    blks = blks.float()
    return blks[:, 4] * blks[:, 5:].max(dim=1).values


def _discrete(got: List[Dict], ref: List[Dict], prefix: str = "") -> Dict[str, float]:
    """``box_gap``, ``quad_gap``, ``raw_gap`` and ``refined_gap`` of the
    pages together (see the module docstring), each name after ``prefix``."""
    blocks_all = lines_all = 0
    box_short = quad_short = 0.0
    raw_i = raw_u = ref_i = ref_u = 0
    for g, r in zip(got, ref):
        box_short += _shortfall(g["blocks"], r["blocks"])
        quad_short += _shortfall(g["lines"], r["lines"], _quad_box)
        blocks_all += len(g["blocks"]) + len(r["blocks"])
        lines_all += len(g["lines"]) + len(r["lines"])
        raw_i += int(np.count_nonzero(g["raw"] & r["raw"]))
        raw_u += int(np.count_nonzero(g["raw"] | r["raw"]))
        ref_i += int(np.count_nonzero(g["refined"] & r["refined"]))
        ref_u += int(np.count_nonzero(g["refined"] | r["refined"]))
    return {
        prefix + "box_gap": box_short / blocks_all if blocks_all else 0.0,
        prefix + "quad_gap": quad_short / lines_all if lines_all else 0.0,
        prefix + "raw_gap": 1.0 - raw_i / raw_u if raw_u else 0.0,
        prefix + "refined_gap": 1.0 - ref_i / ref_u if ref_u else 0.0,
    }


def page_numbers(got: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """``got`` and ``ref``: one dict a page (``reference/pipeline.py::
    detect_page``'s form), in the same order."""
    out = {"mask_gap": 0.0, "shrink_gap": 0.0, "det_gap": 0.0}
    for g, r in zip(got, ref):
        gb, gm, gs = (t.float() for t in g["net"])
        rb, rm, rs = (t.float() for t in r["net"])
        out["mask_gap"] = max(out["mask_gap"], float((gm - rm).abs().mean()))
        out["shrink_gap"] = max(out["shrink_gap"], float((gs - rs).abs().mean()))
        gc, rc = _conf(gb), _conf(rb)
        live = torch.maximum(gc, rc) > 0.1
        if bool(live.any()):
            out["det_gap"] = max(out["det_gap"], float((gc - rc)[live].abs().mean()))
    out.update(_discrete(got, ref))
    return out


def stage_numbers(got: List[Dict], staged: List[Dict]) -> Dict[str, float]:
    """The program's final outputs against the reference's steps after the
    net run on the program's own net outputs (``staged``): ``stage_box_gap``,
    ``stage_quad_gap``, ``stage_raw_gap``, ``stage_refined_gap``."""
    return _discrete(got, staged, "stage_")


def _leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves: Sequence[str]) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and of the median leaf."""
    norms = {k: float(ref[k].double().norm()) for k in leaves}
    median = float(np.median(list(norms.values()))) if norms else 0.0
    worst = 0.0
    for k in leaves:
        base = max(norms[k], median)
        if base > 0:
            worst = max(worst, abs(float(got[k].double().norm()) - norms[k]) / base)
    return worst


def train_numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """``got`` / ``ref``: ``losses`` (mini-steps x terms), ``grad`` (leaf ->
    the first update's gradient as the optimizer takes it) and ``change``
    (leaf -> parameter after the checked updates minus before).

    * ``loss_gap``: the largest relative gap of a loss term over the
      checked mini-steps;
    * ``grad_gap``, ``change_gap``: the worst leaf's gap of norms
      (``_leaf_gap``).  Leaves whose reference gradient is under a
      thousandth of the median leaf's move under Adam by round-off alone
      (a key's bias under softmax, a bias before a BatchNorm) and are left
      out of both, by that rule on the reference's gradient.
    """
    gl, rl = np.asarray(got["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    loss_gap = float(np.max(np.abs(gl - rl) / np.maximum(np.abs(rl), 1e-12)))
    gnorm = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    median = float(np.median(list(gnorm.values())))
    leaves = [k for k in ref["grad"] if gnorm[k] >= 1e-3 * median]
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(got["grad"], ref["grad"], leaves),
        "change_gap": _leaf_gap(got["change"], ref["change"], leaves),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
