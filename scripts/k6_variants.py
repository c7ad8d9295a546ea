"""Time variants of K6 (mask finalize and binarize) on one NVIDIA GPU.

    python3 scripts/k6_variants.py

Run from the root of a checkout.  Builds versions of K6:

* ``first_design``: the first design (a grid-stride loop of one float4
  load and one uchar4 store a thread, the grid capped at 132 x 16 blocks,
  a second launch for the tail; contiguous input only), its source kept
  below;
* ``committed``: ``comic_text_detector_tpu_torch/csrc/finalize.cu`` as
  committed (16 elements a thread, four 16-byte loads in flight, each load
  instruction 512 contiguous bytes of a warp, four 4-byte stores; the page
  from the grid, head and tail in the same launch);
* ``evict_first``: the same with evict-first (``ld.global.cs``) loads;
* ``pdl``: the same launched with programmatic dependent launch, as K1-K3
  are: each launch waits for the one before it (``griddepcontrol.wait``)
  and lets the next one start (``griddepcontrol.launch_dependents``);
* ``consecutive16``: each thread owns 16 consecutive elements, loaded as
  four consecutive float4 and stored as one 16-byte word (a warp's load
  instruction then touches 16 lines of 128 B, the committed one 4);
* ``staged``: the committed loads, the results staged through shared
  memory so that each thread stores 16 consecutive bytes as one word;
* ``per4`` and ``per8``: 4 or 8 elements a thread (one or two float4 loads
  in flight), with 4x or 2x the blocks;
* ``threads128``: blocks of 128 threads, twice as many; ``per8_threads128``
  both changes;
* ``torchlike`` and ``torchlike_ldg``: the layout of PyTorch's vectorized
  elementwise kernel on sm_90 (128 threads a block, 8 consecutive elements
  a thread: two consecutive float4 loads, one 8-byte store), with plain
  or read-only (``__ldg``) loads;
* ``plain_loads``: the committed kernel with plain loads in place of
  ``__ldg``;

and, as the yardstick, ``library``: one PyTorch call for the same function
(``x.mul(255).to(torch.uint8)``, ``torch.gt(x, t).view(torch.uint8)``).

Holds each bit for bit against the plain versions on odd planes, page
strides and offsets, then times both functions at (4, 1024, 1024) and
(4, 1536, 1536) on sigmoid-like maps in four cases: contiguous stacks
cycled past the 50 MB L2 (device memory) into one output, the same with
the outputs cycled too (the library call cannot be given one: it writes
its own), one stack launched again and again (L2-resident), and the batch
stream's form, ``lines[:, 0]`` of a (4, 2, S, S) stack in the L2, which
``first_design`` can only read after a contiguous copy (timed with the copy).
Device time is CUPTI's a launch (``torch.profiler``; both turns printed),
event time is CUDA events over the Python launch loop (the lower turn);
every variant twice, in turns.  Prints the card's name and power limit,
each build's registers (``-Xptxas -v``), and as its last line one JSON
object of times in ms.  Builds go to
``comic_text_detector_tpu_torch/build/variants/``.  Exits 1 without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "comic_text_detector_tpu_torch", "csrc", "finalize.cu")
OUT = os.path.join(ROOT, "comic_text_detector_tpu_torch", "build", "variants")

# The first design of K6, as it was before the page-strided redesign.
_FIRST_DESIGN = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t to_u8(float x) {
    unsigned int v = __float2uint_rz(__fmul_rn(x, 255.0f));
    return (uint8_t)(v > 255u ? 255u : v);
}

struct ToU8 {
    __device__ uint8_t operator()(float x) const { return to_u8(x); }
};

struct Above {
    float t;
    __device__ uint8_t operator()(float x) const { return x > t ? 1 : 0; }
};

template <typename Op>
__global__ void elementwise_vec4(const float4* __restrict__ x, uchar4* __restrict__ out, long long n4, Op op) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
        float4 v = __ldg(x + i);
        out[i] = make_uchar4(op(v.x), op(v.y), op(v.z), op(v.w));
    }
}

template <typename Op>
__global__ void elementwise_scalar(const float* __restrict__ x, uint8_t* __restrict__ out, long long start,
                                   long long n, Op op) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
        out[i] = op(__ldg(x + i));
}

unsigned int grid_for(long long work) {
    long long blocks = (work + kThreads - 1) / kThreads;
    const long long cap = 132 * 16;
    return (unsigned int)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

template <typename Op>
int launch(const float* x, uint8_t* out, long long n, Op op, cudaStream_t stream) {
    if (n <= 0) return (int)cudaGetLastError();
    bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 4 == 0);
    long long n4 = aligned ? n / 4 : 0;
    if (n4 > 0) {
        elementwise_vec4<<<grid_for(n4), kThreads, 0, stream>>>(
            reinterpret_cast<const float4*>(x), reinterpret_cast<uchar4*>(out), n4, op);
    }
    long long start = n4 * 4;
    if (start < n) elementwise_scalar<<<grid_for(n - start), kThreads, 0, stream>>>(x, out, start, n, op);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ctd_mask_to_u8(const float* x, uint8_t* out, long long n, cudaStream_t stream) {
    return launch(x, out, n, ToU8{}, stream);
}

int ctd_binarize(const float* x, uint8_t* out, float thresh, long long n, cudaStream_t stream) {
    return launch(x, out, n, Above{thresh}, stream);
}

}  // extern "C"
"""

_KERNEL_START = "    long long page = (long long)blockIdx.z * gridDim.y + blockIdx.y;\n"
_LAUNCH = ("    finalize_kernel<<<grid, kThreads, 0, stream>>>(x, out, pages, plane, page_stride, op);\n"
           "    return (int)cudaGetLastError();\n")
_PDL_LAUNCH = r"""    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, finalize_kernel<Op>, x, out, pages, plane, page_stride, op);
"""

# Each thread owns kPerThread (8 or 16) consecutive elements: kLoads
# consecutive float4 loads (``load`` is the load function), one 8- or
# 16-byte store.  With 16 this is the layout first prescribed, where a warp's
# load instruction touches 16 lines of 128 B; with 8 and 128 threads a block
# it is the layout of PyTorch's own vectorized elementwise kernel on sm_90.
def _consecutive(load: str) -> str:
    return r"""    long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (c < chunks) {
        long long e = head + kPerThread * c;
        float v[kPerThread];
        if (((uintptr_t)(src + head) & 15u) == 0) {
            const float4* p = reinterpret_cast<const float4*>(src + e);
            float4 q[kLoads];
#pragma unroll
            for (int k = 0; k < kLoads; ++k) q[k] = LOAD(p + k);
#pragma unroll
            for (int k = 0; k < kLoads; ++k) {
                v[4 * k] = q[k].x;
                v[4 * k + 1] = q[k].y;
                v[4 * k + 2] = q[k].z;
                v[4 * k + 3] = q[k].w;
            }
        } else {
#pragma unroll
            for (int k = 0; k < kPerThread; ++k) v[k] = __ldg(src + e + k);
        }
        unsigned int r[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) r[k] = pack4(op, v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
        if constexpr (kLoads == 4)
            *reinterpret_cast<uint4*>(dst + e) = make_uint4(r[0], r[1], r[2], r[3]);
        else
            *reinterpret_cast<uint2*>(dst + e) = make_uint2(r[0], r[1]);
    }
""".replace("LOAD", load)


# The committed loads, with the results staged through shared memory so
# that each thread stores 16 consecutive bytes as one 16-byte word.
_STORE_STAGED = r"""    __shared__ unsigned int stage[kThreads / 32][128];
    unsigned int* st = stage[threadIdx.x >> 5];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) st[32 * k + lane] = pack4(op, q[k].x, q[k].y, q[k].z, q[k].w);
    __syncwarp();
    if (32 * w + lane < chunks)
        *reinterpret_cast<uint4*>(dst + e + 12 * lane) = reinterpret_cast<const uint4*>(st)[lane];
"""
_STORES = "#pragma unroll\n    for (int k = 0; k < kLoads; ++k)\n        if (ok[k]) *reinterpret_cast<unsigned int*>"
_STORES_END = "pack4(op, q[k].x, q[k].y, q[k].z, q[k].w);\n"
_BODY = ("    // warp w takes chunks 32 w .. 32 w + 31;", _STORES_END)

_PER8 = ("constexpr int kPerThread = 16;", "constexpr int kPerThread = 8;")
_THREADS128 = ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")

VARIANTS = {
    "first_design": None,
    "committed": [],
    "consecutive16": [(*_BODY, _consecutive("__ldg"))],
    "torchlike": [(*_BODY, _consecutive("*")), _PER8, _THREADS128],
    "torchlike_ldg": [(*_BODY, _consecutive("__ldg")), _PER8, _THREADS128],
    "plain_loads": [("? __ldg(reinterpret_cast<const float4*>(p))", "? *reinterpret_cast<const float4*>(p)")],
    "staged": [(_STORES, _STORES_END, _STORE_STAGED)],
    "per4": [("constexpr int kPerThread = 16;", "constexpr int kPerThread = 4;")],
    "per8": [_PER8],
    "threads128": [_THREADS128],
    "per8_threads128": [_PER8, _THREADS128],
    "evict_first": [("? __ldg(reinterpret_cast<const float4*>(p))", "? __ldcs(reinterpret_cast<const float4*>(p))")],
    "pdl": [(_KERNEL_START, '    asm volatile("griddepcontrol.wait;" ::: "memory");\n'
                            '    asm volatile("griddepcontrol.launch_dependents;");\n' + _KERNEL_START),
            (_LAUNCH, _PDL_LAUNCH)],
}


def variant_source(edits) -> str:
    if edits is None:
        return _FIRST_DESIGN
    src = open(SOURCE).read()
    for edit in edits:
        # (old, new), or (first line, last line, new) for a span
        old, new = edit[0], edit[-1]
        if src.count(old) != 1 or (len(edit) == 3 and src.count(edit[1]) != 1):
            raise RuntimeError(f"finalize.cu no longer has exactly one {old!r}: update this script")
        if len(edit) == 3:
            i = src.index(old)
            old = src[i:src.index(edit[1], i) + len(edit[1])]
        src = src.replace(old, new)
    return src


def main() -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from comic_text_detector_tpu_torch.ops import cuda_build
    from comic_text_detector_tpu_torch.ops import finalize as K6

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for name, edits in VARIANTS.items():
        cu = os.path.join(OUT, f"k6_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(edits))
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(OUT, f"k6_{name}.so"),
               cu]
        builds[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log, flush=True)
            raise RuntimeError(f"nvcc failed on {name}")
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
        print(f"{name}:\n  " + "\n  ".join(usage), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"k6_{name}.so"))
        if name == "first_design":
            lib.ctd_mask_to_u8.argtypes = [p, p, i64, p]
            lib.ctd_binarize.argtypes = [p, p, ctypes.c_float, i64, p]
        else:
            lib.ctd_mask_to_u8.argtypes = [p, p, i64, i64, i64, p]
            lib.ctd_binarize.argtypes = [p, p, ctypes.c_float, i64, i64, i64, p]
        lib.ctd_mask_to_u8.restype = lib.ctd_binarize.restype = ctypes.c_int
        libs[name] = lib

    def launch(name, fn, x, out):
        """One launch of ``fn`` ("mask_to_u8" or "binarize", threshold 0.3)
        of variant ``name`` on ``x``; ``first_design`` reads a contiguous
        copy of a view that is not contiguous, as the stream gave it one."""
        if name == "library":
            library[fn](x)
            return
        stream = torch.cuda.current_stream().cuda_stream
        lib = libs[name]
        if name == "first_design":
            x = x.contiguous()
            layout = (x.numel(),)
        else:
            x, *layout = K6.plane_layout(x)
        extra = (ctypes.c_float(0.3),) if fn == "binarize" else ()
        rc = getattr(lib, "ctd_" + fn)(x.data_ptr(), out.data_ptr(), *extra, *layout, stream)
        if rc:
            raise RuntimeError(f"{name} {fn}: launch failed ({rc})")

    plain = {"mask_to_u8": K6.mask_to_u8_plain, "binarize": lambda x: K6.binarize_plain(x, 0.3)}
    # one PyTorch call for the same function, the yardstick (it allocates its
    # own output)
    library = {"mask_to_u8": lambda x: x.mul(255).to(torch.uint8),
               "binarize": lambda x: torch.gt(x, 0.3).view(torch.uint8)}
    libs["library"] = None
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    k = np.arange(256, dtype=np.float32) / np.float32(255)
    t = np.float32(0.3)
    edge = np.concatenate([k, np.nextafter(k, np.float32(2)), np.nextafter(k, np.float32(-1)),
                           np.float32([t, np.nextafter(t, np.float32(1)), np.nextafter(t, np.float32(0))])])
    checked = 0
    for b, plane, gap, base in ((1, 1, 0, 0), (5, 15, 3, 1), (5, 16, 16, 0), (1, 17, 0, 3), (4, 4095, 4095, 0),
                                (5, 4097, 4097, 2), (4, 1037 * 13, 1037 * 13, 0), (4, 64 * 64, 64 * 64, 1)):
        buf = rng.random(base + b * (plane + gap) + 16, dtype=np.float32)
        buf[: min(edge.size, buf.size)] = edge[: buf.size]
        full = torch.from_numpy(buf).to(dev)
        for case in ("strided", "contiguous"):
            x = (full.as_strided((b, plane), (plane + gap, 1), base) if case == "strided"
                 else full[base:base + b * plane].view(b, plane))
            for fn, ref_fn in plain.items():
                ref = ref_fn(x)
                for name in libs:
                    out = torch.empty((b, plane), dtype=torch.uint8, device=dev)
                    if name == "library":
                        out = library[fn](x)
                    else:
                        launch(name, fn, x, out)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise AssertionError(f"{name} {fn} differs from the plain version on {case} "
                                             f"{b}x{plane}, gap {gap}, base {base}: {int((out != ref).sum())} values")
                    checked += 1
    print(f"every variant bit-equal to the plain versions ({checked} cases)", flush=True)

    def event_ms(fn, args, iters=200):
        fn(*args[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*args[i % len(args)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, args, reps=40):
        """CUPTI ms a call, summed over every kernel the call launches, each
        the mean over the launches the trace holds; a trace that holds none
        is taken again, and after three the time is None (not measured)."""
        fn(*args[0])
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(reps):
                    fn(*args[i % len(args)])
                torch.cuda.synchronize()
            # each kernel of the call appears about ``reps`` times; records of
            # other work that reach the trace appear a few times, left out
            ours = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count >= reps // 2]
            if ours:
                return sum(e.self_device_time_total / e.count * max(1, round(e.count / reps)) for e in ours) / 1e3
            time.sleep(0.1)
        return None

    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    order = list(libs) + list(libs)[::-1]
    for s in (1024, 1536):
        bound = 4 * s * s * 5 / 3.35e12 * 1e3
        copies = max(2, -(-150_000_000 // (4 * s * s * 5)))
        # sigmoid-like maps: mostly near 0 or 1
        stacks = [torch.sigmoid(torch.randn((4, 2, s, s), device=dev, generator=gen) * 4) for _ in range(copies)]
        outs = [torch.empty((4, s, s), dtype=torch.uint8, device=dev) for _ in range(copies)]
        cases = {
            # inputs cycled, one output (which stays in the L2, as the
            # library call's own output does)
            "device memory": [(st[:, 0].contiguous(), outs[0]) for st in stacks],
            # inputs and outputs cycled: every byte to and from device memory
            "device memory, outputs cycled": [(st[:, 0].contiguous(), o) for st, o in zip(stacks, outs)],
            "L2": [(stacks[0][:, 0].contiguous(), outs[0])],
            "stream view, L2": [(stacks[0][:, 0], outs[0])],
        }
        for case, args in cases.items():
            for fn in plain:
                row = {}
                for name in order:
                    call = lambda x, o, name=name, fn=fn: launch(name, fn, x, o)
                    r = row.setdefault(name, {"device_ms": [], "event_ms": []})
                    r["device_ms"].append(device_ms(call, args))
                    r["event_ms"].append(event_ms(call, args))
                key = f"(4, {s}, {s}) {fn}, {case}"
                results[key] = {"bound_ms": bound, "copies": len(args), **row}
                print(key + ": " + ", ".join(
                    f"{n} device {' / '.join('n/a' if t is None else f'{t:.4f}' for t in v['device_ms'])}, "
                    f"event {min(v['event_ms']):.4f}"
                    for n, v in row.items())
                    + f"; bound {bound:.5f} ms; {smi}", flush=True)
        del stacks, outs, cases
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
