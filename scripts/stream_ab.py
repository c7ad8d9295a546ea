"""Run the batch streams of two checkouts on one card, in turns, and compare.

    python3 scripts/stream_ab.py OTHER_ROOT

Run from the root of a checkout.  Runs the bf16 batch stream
(``BatchTextDetector(..., batch_size=4, half=True, refine_backend="device",
mask_transfer="packed").stream``) at input 1024 on ``chip_smoke.py``'s 12
seeded pages and at input 1536 on its 8 seeded scans, with OTHER_ROOT's
package and with this checkout's, in the turns other, this, this, other,
each turn in a fresh process that builds its own tree's kernels.  Both take
this checkout's ``data/flagship_r2.npz``.  Each turn prints, for each
input size, the device busy ms a page (CUPTI kernel time of one profiled
pass), the wall ms a page (one pass after a warm-up) and a SHA-256 digest
of every output (both masks, each block's xyxy, language and line quads).
Fails if any digest differs from the first turn's.  Prints the card's name
and power limit and, as its last line, one JSON object.  Exits 1 without a
CUDA device.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")


def chip_smoke():
    """This checkout's ``chip_smoke.py`` (its seeded pages), imported by
    path so that the package comes from the turn's tree."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(outputs) -> str:
    import numpy as np

    h = hashlib.sha256()
    for mask, refined, blocks in outputs:
        h.update(np.ascontiguousarray(mask).tobytes())
        h.update(np.ascontiguousarray(refined).tobytes())
        for b in blocks:
            h.update(repr((list(map(int, b.xyxy)), b.language)).encode())
            lines = np.ascontiguousarray(np.asarray(b.lines))
            h.update(str(lines.dtype).encode() + lines.tobytes())
    return h.hexdigest()


def turn(tree: str) -> dict:
    """Both streams with ``tree``'s package: busy and wall ms a page, and
    the digest of the outputs."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from comic_text_detector_tpu_torch.ops import cuda_build
    from comic_text_detector_tpu_torch.pipeline import BatchTextDetector
    from comic_text_detector_tpu_torch.weights import load_npz

    if not os.path.abspath(cuda_build.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"the package came from {cuda_build.__file__}, not from {tree}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    page = chip_smoke().synthetic_page
    variables = load_npz(WEIGHTS)
    result = {"tree": tree}
    for size, shapes, seed, n in ((1024, [(1400, 1000), (1500, 1060), (1056, 1500)], 11, 12),
                                  (1536, [(2150, 1500), (2048, 1448), (1500, 2150)], 15, 8)):
        rng = np.random.default_rng(seed)
        warm = [page(rng, *shapes[i % 3], colour=i % 2 == (1 if size == 1024 else 0)) for i in range(4)]
        pages = [page(rng, *shapes[i % 3], colour=i % 2 == (0 if size == 1024 else 1)) for i in range(n)]
        det = BatchTextDetector(variables, batch_size=4, input_size=size, half=True, refine_backend="device",
                                mask_transfer="packed")
        list(det.stream(iter(warm)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(det.stream(iter(pages)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = list(det.stream(iter(pages)))
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
        d = digest(out)
        if digest(again) != d:
            raise AssertionError(f"the {size} stream's repeat differs")
        result[str(size)] = {"busy_ms_per_page": busy / n, "wall_ms_per_page": wall * 1e3 / n, "digest": d}
    return result


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(os.path.abspath(sys.argv[2]))), flush=True)
        return
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other = os.path.abspath(sys.argv[1])
    turns = []
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree], capture_output=True,
                              text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, flush=True)
            raise RuntimeError(f"the turn on {tree} failed")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(r)
        print(("other " if tree == other else "this  ") + "  ".join(
            f"{s}: busy {r[s]['busy_ms_per_page']:.2f} ms/page, wall {r[s]['wall_ms_per_page']:.2f}, "
            f"digest {r[s]['digest'][:16]}" for s in ("1024", "1536")) + f"; {smi}", flush=True)
    for s in ("1024", "1536"):
        if len({t[s]["digest"] for t in turns}) != 1:
            raise AssertionError(f"the {s} stream's outputs differ between the turns")
    print("outputs bit for bit the same in every turn, at 1024 and 1536", flush=True)
    print(json.dumps({"card": smi, "turns": turns}), flush=True)


if __name__ == "__main__":
    main()
