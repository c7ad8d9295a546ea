"""Time variants of K2's last phase on one NVIDIA GPU.

    python3 scripts/k2_variants.py

Run from the root of a checkout.  Builds
``comic_text_detector_tpu_torch/csrc/cc.cu`` as committed (K2 as local,
border, then a resolve pass that points each tile root at its root and a
gather pass that writes each pixel its tile root's slot), and variants of
it that change the last phase only: one in-place finish pass in which each
foreground pixel walks from its tile root to the root (a thread walks once
for each run of its four pixels that share a tile root), and the same
without that cache of the last tile root.  Holds each variant bit for bit
against ``cc_windows_local_plain`` on masks aimed at the tile seams
(widths 1023 to 2049, heights that are not whole tiles, chains linked only
through NE or NW), then times each at (4, 1024, 1024), (4, 1536, 1536) and
(4, 2048, 2048) on text-like blobs and on 45% noise, cycling copies that
together exceed the 50 MB L2, every variant twice, in turns, and gives the
per-kernel times of each (``torch.profiler``).  Prints the card's name and
power limit, each build's registers and spills (``-Xptxas -v``), and as its
last line one JSON object of times in ms.  Builds go to
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
SOURCE = os.path.join(ROOT, "comic_text_detector_tpu_torch", "csrc", "cc.cu")
OUT = os.path.join(ROOT, "comic_text_detector_tpu_torch", "build", "variants")

_FINISH_KERNEL = r"""
// One pass in place of resolve and gather: every foreground pixel walks from
// its tile root to the root and writes it, the background 2**30; a thread
// walks once for each run of its pixels that share a tile root.
__global__ void finish_roots_kernel(int* parent, long long total, int hw, int* err) {
    griddep_wait();
    long long i0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (i0 >= total) return;
    int v[4], r[4];
    bool whole = load_quad(parent, i0, total, v);
    long long last_base = -1;
    int last_tile_root = -1, last_root = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        r[k] = CC_BIG;
        if (v[k] == kBackground) continue;
        long long base = (i0 + k) - (i0 + k) % hw;
        int t = v[k] >= 0 ? (int)(i0 + k - base) : ~v[k];
        if (t != last_tile_root || base != last_base) {
            last_root = find_root(parent + base, t, hw, err);
            last_tile_root = t;
            last_base = base;
        }
        r[k] = last_root;
    }
    store_quad(parent, i0, total, whole, r);
}

}  // namespace
"""

_SPLIT_LAUNCH = (
    "        rc = launch_after(resolve_kernel<false>, dim3(quads), dim3(kThreads), stream, out, (int*)nullptr, total,\n"
    "                          h * w, err);\n"
    "    if (rc == cudaSuccess)\n"
    "        rc = launch_after(gather_kernel<true>, dim3(quads), dim3(kThreads), stream, (const int*)out, out, total, "
    "h * w);\n"
)
_FINISH_LAUNCH = ("        rc = launch_after(finish_roots_kernel, dim3(quads), dim3(kThreads), stream, out, total, "
                  "h * w, err);\n")
_FINISH = [("}  // namespace\n", _FINISH_KERNEL), (_SPLIT_LAUNCH, _FINISH_LAUNCH)]

VARIANTS = {
    "resolve_gather": [],  # the committed kernel
    "finish": _FINISH,
    "finish_no_cache": _FINISH + [("        if (t != last_tile_root || base != last_base) {\n",
                                   "        if (true) {\n")],
}


def variant_source(edits) -> str:
    src = open(SOURCE).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"cc.cu no longer has exactly one {old!r}: update this script")
        src = src.replace(old, new)
    return src


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from comic_text_detector_tpu_torch.ops import cc_kernels as K
    from comic_text_detector_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for name, edits in VARIANTS.items():
        cu = os.path.join(OUT, name + ".cu")
        with open(cu, "w") as f:
            f.write(variant_source(edits))
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(OUT, name + ".so"), cu]
        builds[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log, flush=True)
            raise RuntimeError(f"nvcc failed on {name}")
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
        print(f"{name}:\n  " + "\n  ".join(usage), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        lib.ctd_cc_window.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ctd_cc_window.restype = ctypes.c_int
        libs[name] = lib

    err = torch.zeros(1, dtype=torch.int32, device="cuda")

    def launch(lib, m, out):
        n, h, w = m.shape
        rc = lib.ctd_cc_window(m.data_ptr(), out.data_ptr(), err.data_ptr(), n, h, w,
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checked = 0
    for n, h, w in ((1, 37, 1023), (1, 37, 1024), (2, 37, 1025), (2, 29, 1536), (1, 1, 2049), (1, 45, 2048),
                    (1, 45, 2049), (1, 8, 1536), (4, 1536, 1536)):
        y, x = np.mgrid[0:h, 0:w]
        kinds = [rng.random((n, h, w)) < 0.45, np.broadcast_to((x + y) % 3 == 0, (n, h, w)),
                 np.broadcast_to((x - y) % 3 == 0, (n, h, w)), np.broadcast_to(x % 2 == 0, (n, h, w)),
                 np.ones((n, h, w))]
        for m_np in kinds:
            m = torch.from_numpy(np.ascontiguousarray(m_np, dtype=np.uint8)).to(dev)
            ref = K.cc_windows_local_plain(m)
            for name, lib in libs.items():
                out = torch.empty(m.shape, dtype=torch.int32, device=dev)
                launch(lib, m, out)
                torch.cuda.synchronize()
                if not torch.equal(out, ref) or int(err.item()):
                    raise AssertionError(f"{name} differs from the plain version at {n}x{h}x{w}")
                checked += 1
    print(f"every variant bit-equal to cc_windows_local_plain ({checked} cases)", flush=True)

    def blobs(n, s):
        m = np.zeros((n, s, s), np.uint8)
        for p in range(n):
            for _ in range(s * s // 400):
                y0, x0 = rng.integers(0, s - 40, 2)
                m[p, y0:y0 + rng.integers(5, 40), x0:x0 + rng.integers(5, 60)] = 1
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

    def phase_ms(lib, m, out, reps=20):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        launch(lib, m, out)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch(lib, m, out)
            torch.cuda.synchronize()
        return {e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]:
                round(e.self_device_time_total / reps / 1e3, 4)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA}

    times, phases = {}, {}
    order = list(libs) + list(libs)[::-1]
    for s in (1024, 1536, 2048):
        for kind, m_np in (("blobs", blobs(4, s)), ("noise 45%", (rng.random((4, s, s)) < 0.45).astype(np.uint8))):
            m = torch.from_numpy(m_np).to(dev)
            copies = max(2, -(-120_000_000 // (m.numel() * 5)))
            args = [(m.clone(), torch.empty(m.shape, dtype=torch.int32, device=dev)) for _ in range(copies)]
            case = f"(4, {s}, {s}) {kind}, set {float(m.float().mean()):.3f}"
            row = {}
            for name in order:
                row.setdefault(name, []).append(cycle_ms(libs[name], args))
            if int(err.item()):
                raise AssertionError("a union-find loop bound was hit while timing")
            times[case] = row
            phases[case] = {name: phase_ms(lib, *args[0]) for name, lib in libs.items()}
            print(case + ": " + ", ".join(f"{k} {min(v):.4f}" for k, v in row.items())
                  + f"; bound {m.numel() * 5 / 3.35e12 * 1e3:.5f} ms; {copies} copies; {smi}", flush=True)
            print("  by kernel: " + json.dumps(phases[case]), flush=True)
    print(json.dumps({"card": smi, "ms": times, "phase_ms": phases}), flush=True)


if __name__ == "__main__":
    main()
