"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each announced on a flushed line
before it starts so a stall shows where it stopped:

1. the card's name and power limit, the torch and CUDA versions;
2. build the CUDA kernels from ``comic_text_detector_tpu_torch/csrc`` (one
   nvcc per source, all started together), with the build time;
3. hold each kernel (K2, K3) and the split ids route bit for bit against
   its plain PyTorch version, small inputs first;
4. the main path: ``TextDetector("data/flagship_r2.npz", input_size=1024)``
   on seeded synthetic pages, with every kernel's launch count set to 0
   just before and read just after; then the kernels against their plain
   versions on the path's own 1024x1024 DB bitmap, their times, and the
   page time;
5. the output check: the same page through the card and through the
   port's CPU route (plain versions) at input size 512 must agree.

Prints ``{"kernels": [...]}`` on a line of its own, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises, and the exit code is
not 0; without a CUDA device, or outside a checkout, it exits 1 before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def synthetic_page(rng, h: int, w: int, colour: bool):
    """Light page with speech bubbles of glyph-like dark strokes."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    base = 205 + 30 * (yy / h)
    page = np.repeat(base[..., None], 3, axis=2)
    if colour:
        page = page * np.array([0.85, 0.95, 1.0]) + np.array([10.0, 0.0, -15.0])
    for _ in range(int(rng.integers(4, 8))):
        cy, cx = rng.integers(h // 8, h - h // 8), rng.integers(w // 8, w - w // 8)
        ry, rx = rng.integers(h // 14, h // 6), rng.integers(w // 14, w // 6)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        page[inside] = 250
        cell = int(rng.integers(14, 26))
        vertical = rng.random() < 0.5
        for r in range(-ry // 2, ry // 2 - cell, cell + cell // 3):
            for c in range(-rx // 2, rx // 2 - cell, cell + 2):
                y0, x0 = (cy + c, cx + r) if vertical else (cy + r, cx + c)
                if not (0 <= y0 < h - cell and 0 <= x0 < w - cell):
                    continue
                for _ in range(int(rng.integers(2, 5))):
                    t = int(rng.integers(2, 4))
                    if rng.random() < 0.5:  # horizontal stroke
                        y = y0 + int(rng.integers(0, cell - t))
                        a, b = sorted(rng.integers(0, cell, 2))
                        page[y:y + t, x0 + a:x0 + b + 1] = 25
                    else:  # vertical stroke
                        x = x0 + int(rng.integers(0, cell - t))
                        a, b = sorted(rng.integers(0, cell, 2))
                        page[y0 + a:y0 + b + 1, x:x + t] = 25
    page = np.clip(page, 0, 255).astype(np.uint8)
    if not colour:
        page[..., 1] = page[..., 0]
        page[..., 2] = page[..., 0]
    return page


def serpentine(s: int):
    import numpy as np

    m = np.zeros((s, s), np.uint8)
    m[::2, :] = 1
    for r in range(0, s - 2, 2):
        m[r + 1, 0 if (r // 2) % 2 == 0 else s - 1] = 1
    return m


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "comic_text_detector_tpu_torch")) or not os.path.exists(WEIGHTS):
        fail("run from a checkout of the repository: the port package or data/flagship_r2.npz is missing")
    import numpy as np

    from comic_text_detector_tpu_torch.ops import cc_kernels as K

    phase("1/5 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("2/5 build kernels (nvcc)")
    t0 = time.perf_counter()
    K.build()
    phase(f"build time {time.perf_counter() - t0:.1f} s")

    phase("3/5 kernels vs plain versions, bit for bit")
    rng = np.random.default_rng(0)
    blob = np.zeros((1024, 1024), np.uint8)
    blob[80:960, 120:900] = 1
    blob[rng.random(blob.shape) < 0.08] = 0
    cases = [
        ("noise 64x128", (rng.random((2, 64, 128)) < 0.45).astype(np.uint8)),
        ("serpentine 256x256", serpentine(256)[None]),
        ("noise 45% 1024x1024", (rng.random((1, 1024, 1024)) < 0.45).astype(np.uint8)),
        ("blob 8% holes 1024x1024", blob[None]),
    ]

    def hold(name: str, m_np) -> dict:
        """Kernel vs plain version on one input; returns the max abs errors."""
        m = torch.from_numpy(m_np).to(dev)
        seeds = torch.from_numpy(
            np.where(m_np > 0, rng.integers(0, 1 << 20, m_np.shape), K.CC_BIG).astype(np.int32)
        ).to(dev)
        pairs = [
            ("K2", K.cc_windows_local(m), K.cc_windows_local_plain(m)),
            ("K3", K.min_prop_windows_local(m, seeds), K.min_prop_windows_local_plain(m, seeds)),
            ("ids", K.cc_ids_windows_local(m), K.cc_ids_windows_local_plain(m)),
        ]
        torch.cuda.synchronize()
        errs = {}
        for kname, got, ref in pairs:
            errs[kname] = int((got.long() - ref.long()).abs().max())
            if errs[kname] != 0:
                bad = int((got != ref).sum())
                raise AssertionError(f"{kname} differs from its plain version on {name}: {bad} pixels")
        phase(f"  {name}: K2, K3, ids bit-equal")
        return errs

    for name, m_np in cases:
        hold(name, m_np)

    phase("4/5 main path: TextDetector at 1024, flagship_r2 weights")
    from comic_text_detector_tpu_torch.ops.db_decode import db_decode_full_device
    from comic_text_detector_tpu_torch.ops.nms import nms_single
    from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8, letterbox_shape, resize_cv2exact_u8
    from comic_text_detector_tpu_torch.pipeline import TextDetector

    det = TextDetector(WEIGHTS, input_size=1024)
    pages = [
        synthetic_page(rng, 1400, 1000, colour=False),
        synthetic_page(rng, 1100, 1600, colour=True),
        synthetic_page(rng, 1400, 1000, colour=True),
    ]
    K.cc_windows_local.launches = 0
    K.min_prop_windows_local.launches = 0
    results = [det(p) for p in pages]
    torch.cuda.synchronize()
    launches = {"K2": K.cc_windows_local.launches, "K3": K.min_prop_windows_local.launches}
    phase(f"  launches on the main path: {launches}")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched on the main path")
    for p, (mask, refined, blks) in zip(pages, results):
        if mask.shape != p.shape[:2] or refined.shape != p.shape[:2] or mask.dtype != np.uint8:
            raise AssertionError(f"mask shapes {mask.shape} {refined.shape} for page {p.shape}")
        n_lines = sum(len(b.lines) for b in blks)
        phase(f"  page {p.shape}: {len(blks)} blocks, {n_lines} lines, mask>30 {(mask > 30).mean():.4f}")

    # the path's own DB bitmap
    with torch.no_grad():
        lb = letterbox_device_u8(torch.from_numpy(pages[0]).to(dev), 1024)
        x = lb.permute(2, 0, 1)[None].float() / 255.0
        blks_t, mask_t, lines_t = det.model(x)
    for t in (blks_t, mask_t, lines_t):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite net output")
    if tuple(mask_t.shape) != (1, 1, 1024, 1024) or tuple(lines_t.shape) != (1, 2, 1024, 1024):
        raise AssertionError(f"net output shapes {tuple(mask_t.shape)} {tuple(lines_t.shape)}")
    bitmap = (lines_t[0, 0] > det.db_thresh).to(torch.uint8)[None].contiguous()
    ids = K.cc_ids_windows_local(bitmap)
    n_comp = int(ids.max())
    phase(f"  DB bitmap: {int(bitmap.sum())} fg pixels, {n_comp} components")
    db_errs = hold("DB bitmap of page 0", bitmap.cpu().numpy())

    seeds = torch.where(ids > 0, ids, K.CC_BIG).to(torch.int32)
    out = torch.empty_like(seeds)
    parent = torch.empty_like(seeds)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    k2_ms = cuda_ms(lambda: K.launch_cc_window(bitmap, out, err), 50)
    k3_ms = cuda_ms(lambda: K.launch_min_prop_window(bitmap, seeds, parent, out, err), 50)
    if int(err.item()):
        raise AssertionError("a union-find loop bound was hit while timing")
    k2_plain = cuda_ms(lambda: K.cc_windows_local_plain(bitmap), 5)
    k3_plain = cuda_ms(lambda: K.min_prop_windows_local_plain(bitmap, seeds), 5)
    px = bitmap.numel()
    k2_bytes = px * 1 + px * 4  # mask in, labels out
    k3_bytes = px * 1 + px * 4 + px * 4  # mask + seeds in, ids out

    for p in pages:  # warm-up done above; now timed
        det(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        for p in pages:
            det(p)
    torch.cuda.synchronize()
    page_ms = (time.perf_counter() - t0) * 1e3 / (reps * len(pages))
    step_ms = cuda_ms(lambda: det._device_step(pages[0]), 5)
    phase(f"  {page_ms:.1f} ms/page end to end, {step_ms:.1f} ms device step (page {pages[0].shape})")

    # each stage of the device step alone, on page 0's tensors
    img_dev = torch.from_numpy(pages[0]).to(dev)
    h0, w0 = pages[0].shape[:2]
    _, _, dw0, dh0, _ = letterbox_shape(h0, w0, 1024)
    mask_u8 = (mask_t[0, 0] * 255.0).to(torch.uint8)
    with torch.no_grad():
        stages = {
            "upload": cuda_ms(lambda: torch.from_numpy(pages[0]).to(dev), 5),
            "letterbox": cuda_ms(lambda: letterbox_device_u8(img_dev, 1024), 5),
            "net": cuda_ms(lambda: det.model(x), 5),
            "nms": cuda_ms(lambda: nms_single(blks_t[0], det.conf_thresh, det.nms_thresh), 5),
            "mask_unletterbox": cuda_ms(
                lambda: resize_cv2exact_u8(mask_u8[: 1024 - dh0, : 1024 - dw0], (h0, w0)), 5),
            "db_decode": cuda_ms(lambda: db_decode_full_device(lines_t[0, 0], det.db_thresh), 5),
        }
    phase("  device step by stage (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    phase("5/5 output check: card vs the port's CPU route at 512")
    small = synthetic_page(np.random.default_rng(7), 560, 720, colour=False)
    det_gpu = TextDetector(WEIGHTS, input_size=512)
    det_cpu = TextDetector(WEIGHTS, input_size=512, device="cpu")
    mg, rg, bg = det_gpu(small.copy())
    mc, rc, bc = det_cpu(small.copy())
    mdiff = int(np.abs(mg.astype(np.int16) - mc).max())
    if mdiff > 1:
        raise AssertionError(f"grey mask differs by {mdiff} levels between card and CPU")
    if len(bg) != len(bc) or not bc:
        raise AssertionError(f"{len(bg)} blocks on the card, {len(bc)} on the CPU")
    for a, b in zip(bg, bc):
        la, lb_ = np.asarray(a.lines), np.asarray(b.lines)
        if np.abs(np.asarray(a.xyxy) - np.asarray(b.xyxy)).max() > 1 or la.shape != lb_.shape:
            raise AssertionError(f"block {a.xyxy} ({len(a.lines)} lines) vs {b.xyxy} ({len(b.lines)} lines)")
        if la.size and np.abs(la - lb_).max() > 1:
            raise AssertionError(f"line quads of block {a.xyxy} differ by more than 1 px")
    iou = np.logical_and(rg > 0, rc > 0).sum() / max(np.logical_or(rg > 0, rc > 0).sum(), 1)
    if iou < 0.99:
        raise AssertionError(f"refined mask IoU {iou:.4f} between card and CPU")
    phase(f"  card and CPU agree: {len(bg)} blocks, mask within {mdiff} level, refined IoU {iou:.4f}")

    kernels = [
        {
            "name": "cc_window (K2)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:300",
            "launches": launches["K2"], "max_abs_err": db_errs["K2"], "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "min_prop_window (K3)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:320",
            "launches": launches["K3"], "max_abs_err": db_errs["K3"], "ms": k3_ms, "plain_ms": k3_plain,
            "bound_ms": k3_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
    ]
    print(json.dumps({"page_ms": page_ms, "device_step_ms": step_ms, "stage_ms": stages, "db_components": n_comp,
                      "pages": [list(p.shape) for p in pages], "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
