"""Where the YOLO block trainer's step spends its time, on one NVIDIA GPU.

    python3 scripts/yolo_step_stages.py

Run from the root of a checkout.  Builds ``BlkDetTrain`` from the flagship
weights (``data/flagship_r2.npz``'s ``blk_det``, full YOLOv5s width and
depth) with Adam, and one batch of 8 seeded synthetic pages at 512x512
(``chip_smoke.py``'s pages and loader, the configuration its phase 15
trains), then times, under deterministic cuDNN without TF32 (the step's
own settings):

* the step by cumulative stage: the forward, + the loss, + the backward,
  + the update (``yolo_train_step`` itself), each in ms to a synchronize,
  device busy ms and kernel launches (CUPTI through ``torch.profiler``);
* the same step with the model and its input in channels-last memory
  (cuDNN's NHWC kernels), from the same state: ms, busy ms, its first
  loss beside the step's and its top kernels.

A measurement only: the port trains in contiguous NCHW memory.  Prints the
card's name and power limit and, as its last line, one JSON object of the
numbers.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(fn, iters: int = 10, warmup: int = 2) -> float:
    """ms a call of ``fn``, to a synchronize, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("yolo_step_stages: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import WEIGHTS, step_kernels, write_pages
    from comic_text_detector_tpu_torch.data import blk_dataset
    from comic_text_detector_tpu_torch.training import yolo_trainer
    from comic_text_detector_tpu_torch.training.steps import Optimizer, create_yolo_train_state, yolo_train_step
    from comic_text_detector_tpu_torch.training.yolo_loss import yolo_loss
    from comic_text_detector_tpu_torch.weights import blk_train_from_deploy, load_npz

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    imgsz, bs = 512, 8
    yolo_vars = blk_train_from_deploy(load_npz(WEIGHTS))

    def state():
        model = yolo_trainer.build_model(yolo_vars).to(dev)
        return create_yolo_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.9))

    with tempfile.TemporaryDirectory(prefix="ctd_yolo_stages_") as work:
        train_dir = write_pages(os.path.join(work, "train"), np.random.default_rng(14), bs)
        _, loader = blk_dataset.create_dataloader(train_dir, imgsz, bs, as_uint8=True, shuffle=False)
        imgs, labels, mask = (torch.from_numpy(x).to(dev) for x in next(iter(loader)))
    x = (imgs.permute(0, 3, 1, 2).float() / 255.0).contiguous()  # the step's own input (steps._as_float_img)

    st = state()
    st.model.train()
    spec = st.model.spec

    def loss_of(s, inp):
        return yolo_loss(s.model(inp, decode=False)[0], labels, mask, spec.anchors, spec.strides, spec.nc)["loss"]

    def backward():
        st.optimizer.zero_grad()
        loss_of(st, x).backward()

    stages = {"forward": lambda: st.model(x, decode=False), "+ loss": lambda: loss_of(st, x), "+ backward": backward,
              "+ update (the step)": lambda: yolo_train_step(st, imgs, labels, mask)}
    res = {"card": smi, "imgsz": imgsz, "batch": bs, "stage_ms": {}, "stage_busy_ms": {}, "stage_launches": {}}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for k, fn in stages.items():
            res["stage_ms"][k] = timed(fn)
            by_kernel = step_kernels(fn, 2)
            res["stage_launches"][k] = sum(v[1] for v in by_kernel.values())
            res["stage_busy_ms"][k] = sum(v[0] for v in by_kernel.values())
            print(f"{k}: {res['stage_ms'][k]:.2f} ms to a synchronize, busy {res['stage_busy_ms'][k]:.2f} ms, "
                  f"{res['stage_launches'][k]:g} launches; {smi}", flush=True)

    first = float(yolo_train_step(state(), imgs, labels, mask)["loss"])
    cl = state()
    cl.model.to(memory_format=torch.channels_last).train()
    x_cl = x.contiguous(memory_format=torch.channels_last)

    def cl_step():
        cl.optimizer.zero_grad()
        loss = loss_of(cl, x_cl)
        loss.backward()
        cl.optimizer.step()
        return loss

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        cl_first = float(cl_step())
        cl_ms = timed(cl_step)
        cl_kernels = step_kernels(cl_step, 2)
    cl_busy = sum(v[0] for v in cl_kernels.values())
    cl_top = sorted(cl_kernels.items(), key=lambda kv: -kv[1][0])[:3]
    print(f"channels-last step: {cl_ms:.2f} ms, busy {cl_busy:.2f} ms; first loss {cl_first:.7f} against "
          f"{first:.7f}; top kernels: " + ", ".join(f"{k[:60]} {v[0]:.2f} x{v[1]:g}" for k, v in cl_top)
          + f"; {smi}", flush=True)
    res.update(channels_last_ms=cl_ms, channels_last_busy_ms=cl_busy, channels_last_first_loss=[cl_first, first],
               channels_last_top_kernels={k[:80]: v for k, v in cl_top})
    print(json.dumps(res))


if __name__ == "__main__":
    main()
