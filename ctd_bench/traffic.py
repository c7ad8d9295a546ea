"""The one traffic generator: every mix in ``traffic/<name>.json`` is
parameters of it.

A mix names its ``loop`` (``loops/<loop>.py``) and the pool it is fed
from.  Pages (``pages``): ``pool`` synthetic pages of the given (h, w)
``shapes`` in turn, half of them in colour (two of every four), with a fixed number of
speech bubbles by position (``bubbles``, cycled), so that every seed gives
the same sizes and the same amount of text in another layout.  Training
batches (``batches``): ``pool`` batches of ``batch`` square pages of side
``imgsz`` with their DB ground truth (``maps.py``).  Page ``i`` is drawn from
``numpy.random.default_rng([seed, i])``: the same seed gives the same
inputs, and the pages are made in a few worker processes at once.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List

import numpy as np

from ctd_bench.maps import MakeBorderMap, MakeShrinkMap
from ctd_bench.pages import synthetic_page

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str, where: str = os.path.join(HERE, "traffic")) -> Dict:
    with open(os.path.join(where, f"{name}.json")) as f:
        return json.load(f)


def _page_spec(mix: Dict, i: int):
    h, w = mix["shapes"][i % len(mix["shapes"])]
    bubbles = mix["bubbles"][i % len(mix["bubbles"])]
    return int(h), int(w), (i // 2) % 2 == 0, int(bubbles)


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _map(fn, items):
    """``fn`` over ``items`` in worker processes (spawned, so that no lock of
    the parent's threads is inherited; they import NumPy and this module
    alone), in order."""
    items = list(items)
    if len(items) < 2 or _workers() == 1:
        return [fn(x) for x in items]
    with ProcessPoolExecutor(_workers(), mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(fn, items))


def _page(args):
    mix, seed, i = args
    h, w, colour, bubbles = _page_spec(mix, i)
    return synthetic_page(np.random.default_rng([seed, i]), h, w, colour, bubbles=bubbles)


def page_pool(mix: Dict, seed: int) -> List[np.ndarray]:
    """The mix's pool of BGR uint8 pages, in the order they are served."""
    return _map(_page, [(mix, seed, i) for i in range(mix["pool"])])


def sample_indices(mix: Dict, seed: int, n_pool: int) -> List[int]:
    """The pool positions whose outputs are compared with the reference:
    ``sample`` of them drawn from the seed, the largest page among them."""
    sizes = [_page_spec(mix, i)[0] * _page_spec(mix, i)[1] for i in range(n_pool)]
    largest = int(np.argmax(sizes))
    rng = np.random.default_rng([seed, 1])
    rest = [int(i) for i in rng.permutation(n_pool) if i != largest]
    return sorted([largest] + rest[: mix["sample"] - 1])


def _train_row(args):
    mix, seed, i = args
    size = mix["imgsz"]
    bubbles = int(mix["bubbles"][i % len(mix["bubbles"])])
    page, _mask, quads, _blocks = synthetic_page(np.random.default_rng([seed, i]), size, size, (i // 2) % 2 == 0,
                                                 truth=True, bubbles=bubbles)
    data = {"imgs": page, "text_polys": quads.reshape(-1, 4, 2).astype(np.int64), "ignore_tags": [False] * len(quads)}
    data = MakeBorderMap(shrink_ratio=0.4)(MakeShrinkMap(shrink_ratio=0.4)(data))
    data["imgs"] = np.ascontiguousarray(page[:, :, ::-1])  # the loader's RGB
    return {k: data[k] for k in ("imgs", "shrink_map", "shrink_mask", "threshold_map", "threshold_mask")}


def train_pool(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The mix's pool of DB training batches: imgs (B, S, S, 3) RGB uint8,
    shrink_map, shrink_mask, threshold_map, threshold_mask (B, S, S)
    float32, as ``data/db_dataset.py`` hands them to the train step."""
    bs = mix["batch"]
    rows = _map(_train_row, [(mix, seed, i) for i in range(mix["pool"] * bs)])
    return [{k: np.stack([r[k] for r in rows[b * bs:(b + 1) * bs]]) for k in rows[0]} for b in range(mix["pool"])]
