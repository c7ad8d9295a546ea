"""The distribution of a cell's comparison over many seeds, in one process,
with the lower-precision control beside it: what a cell's limits are set
from (``limits/<workload>.json``).

    python3 ctd_bench/tools/gap_probe.py --workload <cell> --seeds 100 [--first 1000]
        [--controls 3] [--faults 3] [--seconds 3] [--max-seconds 600] [--out FILE]

Page cells: the cell's loop sets up once and is re-seeded for each seed
(a new pool, warmed), runs a short window through the timed path and is
compared with the float32 reference, as a run compares it.  For the first
``--controls`` seeds the control, the reference computed in the nearest
precision below the configuration's (``config["control"]``: fp8 for bf16,
TF32 for float32), is compared with the float32 reference on the same
pages, as if it were the program; for the steps after the net the control
is those steps run on the program's net outputs rounded to
``config["stage_control"]`` (fp8 for bf16, bf16 for float32), compared
with the same steps on the outputs as they are.

The DB training cell: for each seed the loop's set-up (the pool, the
train state, the checked updates) and the float32 reference on the same
batches; the control is the reference in TF32; for the first ``--faults``
seeds two faults of the program are read too: ``half`` (each step on the
first half of its batch, the mean over it) and ``unchanged`` (the state
left as it was: the parameters' change reads 1).

Prints one JSON line per seed and writes everything, with each number's
largest program reading and smallest control and fault readings, to
``--out`` (default ``gap_probe_<workload>.json`` in the working directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".ctd_bench_cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".ctd_bench_cache", "triton"))


def page_probe(args, entry, config, mix, device, emit):
    import torch

    from ctd_bench import compare, harness
    from ctd_bench.loops import common
    from ctd_bench.reference import pipeline as ref

    loop = harness.load_loop(mix["loop"])
    model = ref.inference_model(config, device)
    st = None
    t0 = time.perf_counter()
    for j in range(args.seeds):
        seed = args.first + j
        st = loop.setup(config, mix, seed, device, False) if st is None else loop.reseed(st, seed)
        loop.window(st, args.seconds, False)
        outs = loop.outputs(st)
        row = {"seed": seed, "program": common.check_pages(config, mix, device, outs, model)}
        if j < args.controls:
            with torch.no_grad():
                ctl = [ref.detect_page(model, p, mix["input_size"], config, device, config["control"])
                       for p in outs["pages"]]
                want = [ref.detect_page(model, p, mix["input_size"], config, device) for p in outs["pages"]]
            row["control"] = compare.page_numbers(ctl, want)
            size, low = mix["input_size"], config["stage_control"]
            staged = [ref.page_stages(p, g["net"], size, config) for p, g in zip(outs["pages"], outs["results"])]
            ctl = [ref.page_stages(p, ref.rounded(g["net"], low), size, config)
                   for p, g in zip(outs["pages"], outs["results"])]
            row["control"].update(compare.stage_numbers(ctl, staged))
        emit(row)
        if time.perf_counter() - t0 > args.max_seconds:
            break


def train_probe(args, entry, config, mix, device, emit):
    import torch

    from ctd_bench import compare
    from ctd_bench.loops import train_db

    t0 = time.perf_counter()
    for j in range(args.seeds):
        seed = args.first + j
        st = train_db.setup(config, mix, seed, device, False)
        got, batches = st["got"], st["batches"]
        train_db.release(st)
        ref = train_db.reference_run(config, mix, device, batches)
        row = {"seed": seed, "program": compare.train_numbers(got, ref)}
        if j < args.controls:
            ctl = train_db.reference_run(config, mix, device, batches, config["control"])
            row["control"] = compare.train_numbers(ctl, ref)
        if j < args.faults:
            half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
            st = train_db.setup(config, dict(mix), seed, device, False, batches=half)
            row["fault_half"] = compare.train_numbers(st["got"], ref)
            train_db.release(st)
            unchanged = dict(got, change={k: torch.zeros_like(v) for k, v in got["change"].items()})
            row["fault_unchanged"] = compare.train_numbers(unchanged, ref)
        emit(row)
        del batches
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if time.perf_counter() - t0 > args.max_seconds:
            break


def summarise(rows):
    out = {}
    for kind in ("program", "control", "fault_half", "fault_unchanged"):
        have = [r[kind] for r in rows if kind in r]
        if not have:
            continue
        keys = have[0].keys()
        pick = max if kind == "program" else min
        out[kind] = {k: pick(h[k] for h in have) for k in keys}
        out[kind + "_seeds"] = len(have)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=100)
    p.add_argument("--first", type=int, default=1000)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--max-seconds", type=float, default=600.0)
    p.add_argument("--out")
    args = p.parse_args()
    import torch

    from ctd_bench import harness, traffic

    entry = harness.cell_entry(harness.benchmark(), args.workload)
    config = harness.load_config(entry["config"])
    mix = traffic.load_mix(entry["traffic"])
    if not torch.cuda.is_available():
        raise SystemExit("gap_probe: needs a CUDA device")
    device = torch.device("cuda", 0)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    (train_probe if mix["loop"] == "train_db" else page_probe)(args, entry, config, mix, device, emit)
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "rows": rows,
              "summary": summarise(rows)}
    out = args.out or f"gap_probe_{args.workload}.json"
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
