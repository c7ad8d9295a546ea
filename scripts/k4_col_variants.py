"""Time variants of K4's column kernel on one NVIDIA GPU.

    python3 scripts/k4_col_variants.py

Run from the root of a checkout.  Builds
``comic_text_detector_tpu_torch/csrc/scan.cu`` as committed, and variants of
it that change one design choice of the column kernel: row chunks a column,
columns a strip, rows a tile, blocks an SM (which caps the registers), or a
forward walk that writes only the pixels it makes final.  Holds each
variant bit for bit against the plain column sweep on masks of several
heights, then times each at (4, 1536, 1536) and (4, 2048, 2048) on
text-like blobs and on 45% noise, cycling 2 copies (more than the 50 MB
L2), every variant twice, in turns.  Prints the card's name and power
limit, each build's registers and spills (``-Xptxas -v``), and as its last
line one JSON object of times in ms.  Builds go to
``comic_text_detector_tpu_torch/build/variants/``.  Exits 1 without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "comic_text_detector_tpu_torch", "csrc", "scan.cu")
OUT = os.path.join(ROOT, "comic_text_detector_tpu_torch", "build", "variants")

# (row chunks a column, columns a strip, rows a tile, blocks an SM or 0 for
# the committed launch bounds, forward walk writes every pixel)
VARIANTS = (
    (32, 32, 8, 0, True),  # the committed kernel
    (32, 32, 8, 0, False),
    (32, 32, 12, 0, True),
    (32, 32, 16, 0, True),
    (32, 32, 4, 2, True),
    (32, 32, 8, 2, True),
    (16, 32, 8, 2, True),
    (16, 32, 16, 2, True),
    (16, 32, 8, 3, True),
    (24, 32, 8, 2, True),
    (24, 32, 6, 2, True),
    (28, 32, 6, 2, True),
    (64, 16, 8, 0, True),
    (128, 8, 8, 0, True),
)


def variant_source(chunks: int, lanes: int, tile: int, min_blocks: int, write_all: bool) -> str:
    src = open(SOURCE).read()
    edits = [
        ("constexpr int kColChunks = 32; ", f"constexpr int kColChunks = {chunks}; "),
        ("constexpr int kColLanes = 32; ", f"constexpr int kColLanes = {lanes}; "),
        ("constexpr int kTile = 8; ", f"constexpr int kTile = {tile}; "),
    ]
    if min_blocks:
        edits.append(("__launch_bounds__(kColLanes * kColChunks)\n",
                      f"__launch_bounds__(kColLanes * kColChunks, {min_blocks})\n"))
    if not write_all:
        # the forward walk writes unset pixels and each run's last pixel only;
        # the backward walk writes the rest of each run, as before
        edits += [
            ("        bool s[kTile];\n        int v[kTile];\n#pragma unroll\n"
             "        for (int t = 0; t < kTile; ++t) s[t] = q + t < n && row_set(bits, in_bits, mp, q + t, w);",
             "        bool s[kTile + 1];\n        int v[kTile];\n#pragma unroll\n"
             "        for (int t = 0; t <= kTile; ++t) s[t] = q + t < n && row_set(bits, in_bits, mp, q + t, w);"),
            ("                op[(long long)(q + t) * w] = v[t];\n",
             "                if (!s[t] || !s[t + 1]) op[(long long)(q + t) * w] = v[t];\n"),
        ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"scan.cu no longer has exactly one {old!r}: update this script")
        src = src.replace(old, new)
    return src


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from comic_text_detector_tpu_torch.ops import cuda_build
    from comic_text_detector_tpu_torch.ops import scan_kernels as S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for spec in VARIANTS:
        name = "chunks{}_lanes{}_tile{}_blocks{}_{}".format(*spec[:4], "all" if spec[4] else "final")
        cu = os.path.join(OUT, name + ".cu")
        with open(cu, "w") as f:
            f.write(variant_source(*spec))
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(OUT, name + ".so"), cu]
        builds[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log, flush=True)
            raise RuntimeError(f"nvcc failed on {name}")
        kernel = log[log.index("col_sweep_kernel"):]
        usage = [ln.strip() for ln in kernel.splitlines()[2:4]]
        print(f"{name}: {' | '.join(usage)}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        lib.ctd_cc_col_sweep.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ctd_cc_col_sweep.restype = ctypes.c_int
        libs[name] = lib

    def launch(lib, lab, m, out):
        n, h, w = lab.shape
        rc = lib.ctd_cc_col_sweep(lab.data_ptr(), m.data_ptr(), out.data_ptr(), n, h, w,
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for h, w in ((1, 40), (33, 65), (1535, 97), (1537, 97), (2049, 70), (3001, 97), (4, 1536), (1536, 1531)):
        for m_np in ((rng.random((2, h, w)) < 0.45), (rng.random((2, h, w)) < 0.9), np.ones((2, h, w))):
            m = torch.from_numpy(m_np.astype(np.uint8)).to(dev)
            lab = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, m.shape, dtype=np.int64).astype(np.int32)).to(dev)
            ref = S.cc_col_sweep_plain(lab, m)
            for name, lib in libs.items():
                out = torch.empty_like(lab)
                launch(lib, lab, m, out)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} differs from the plain column sweep at {h}x{w}")
    print("every variant bit-equal to the plain column sweep", flush=True)

    def blobs(n, s):
        m = np.zeros((n, s, s), np.uint8)
        for p in range(n):
            for _ in range(s * s // 400):
                y, x = rng.integers(0, s - 40, 2)
                m[p, y:y + rng.integers(5, 40), x:x + rng.integers(5, 60)] = 1
        m[rng.random(m.shape) > 0.97] = 1
        return m

    def cycle_ms(lib, args, iters=100):
        launch(lib, *args[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            launch(lib, *args[i % len(args)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times = {}
    order = list(libs) + list(libs)[::-1]
    for s in (1536, 2048):
        for kind, m_np in (("blobs", blobs(4, s)), ("noise 45%", (rng.random((4, s, s)) < 0.45).astype(np.uint8))):
            m = torch.from_numpy(m_np).to(dev)
            lin = torch.arange(s * s, dtype=torch.int32, device=dev).view(1, s, s)
            lab = torch.where(m != 0, lin, 2**30).contiguous()
            args = [(lab.clone(), m.clone(), torch.empty_like(lab)) for _ in range(2)]
            case = f"(4, {s}, {s}) {kind}, set {float(m.float().mean()):.3f}"
            row = {}
            for name in order:
                row.setdefault(name, []).append(cycle_ms(libs[name], args))
            times[case] = row
            print(case + ": " + ", ".join(f"{k} {min(v):.4f}" for k, v in row.items())
                  + f"; bound {m.numel() * 9 / 3.35e12 * 1e3:.4f} ms; {smi}", flush=True)
    print(json.dumps({"card": smi, "ms": times}), flush=True)


if __name__ == "__main__":
    main()
