"""Data parallelism: the mesh and a launcher.

Counterpart of the JAX package's ``parallel/mesh.py``.  There a
``jax.sharding.Mesh`` with a ``data`` axis shards dimension 0 of each batch
and one jit computes the function of the global batch, XLA inserting the
collectives.  Here a :class:`Mesh` names the devices this process drives
and, in a launched run, the ``torch.distributed`` process group that joins
the processes; the code that needs a cross-device statistic calls the
collectives of ``parallel/collectives.py`` itself.

* :func:`shard_batch` cuts contiguous dim-0 blocks, JAX's
  ``P("data", None, ...)``: rank r of W holds rows ``[r*n/W, (r+1)*n/W)``
  of a global batch of n, so the ranks' blocks in rank order are the
  global batch in its flat order.
* :func:`spawn` starts one process a rank (``spawn`` start method), joins
  them through a ``file://`` store in a temporary directory, and raises in
  the caller the exception of the first rank that failed.
"""

from __future__ import annotations

import copy
import datetime
import itertools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from comic_text_detector_tpu_torch.parallel.collectives import all_reduce, broadcast
from comic_text_detector_tpu_torch.utils.device import resolve_device


class Mesh:
    """The devices this process drives along the ``data`` axis, and the
    process group (``None`` outside a launched run) whose ranks each drive
    as many.  ``shape["data"]`` is the number of batch shards: devices
    times the group's size."""

    def __init__(self, devices: Sequence[torch.device], axis_names: Sequence[str] = ("data",), group=None):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if axis_names[0] != "data":
            raise ValueError(f"the first mesh axis must be 'data', got {tuple(axis_names)}")
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.group = group

    @property
    def world(self) -> int:
        """Processes in the group (1 without one)."""
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This process's rank in the group (0 without one)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def shape(self) -> Dict[str, int]:
        return {name: (len(self.devices) * self.world if name == "data" else 1) for name in self.axis_names}


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("data",), devices=None, group=None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device, or with a
    ``group`` the current CUDA device, one a process), the first
    ``n_devices`` of them if given.  A CUDA device the machine lacks raises
    (``utils/device.py::resolve_device``)."""
    if devices is None:
        resolve_device("cuda")
        if group is not None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and d.index is not None and d.index >= torch.cuda.device_count():
            raise ValueError(f"{d} requested but the machine has {torch.cuda.device_count()} CUDA devices")
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axes, group)


def shard_batch(mesh: Mesh, x) -> List[torch.Tensor]:
    """This process's contiguous dim-0 blocks of the global batch ``x`` (a
    tensor or an array), one a device, each on its device; raises when the
    ``data`` axis does not divide the batch."""
    x = torch.as_tensor(x)
    shards = mesh.shape["data"]
    if x.shape[0] % shards:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {shards} equal shards")
    per = x.shape[0] // shards
    first = mesh.rank * len(mesh.devices)
    return [x[(first + i) * per:(first + i + 1) * per].to(d) for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, obj):
    """A copy of ``obj`` (a module or a tensor) on each of this process's
    devices."""
    if isinstance(obj, nn.Module):
        return [copy.deepcopy(obj).to(d) for d in mesh.devices]
    return [torch.as_tensor(obj).to(d, copy=True) for d in mesh.devices]


@torch.no_grad()
def broadcast_module(mesh: Optional[Mesh], module: nn.Module, src: int = 0) -> None:
    """Overwrite the parameters and buffers of ``module`` with rank
    ``src``'s, in place: one broadcast for each dtype (nothing to do
    without a group)."""
    if mesh is None or mesh.group is None:
        return
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = broadcast(torch.cat([t.reshape(-1) for t in group]), mesh.group, src)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def from_rank0(mesh: Optional[Mesh], fn: Callable[[], Sequence[float]], size: int) -> List[float]:
    """The ``size`` numbers ``fn()`` returns, computed on rank 0 alone and
    broadcast to every rank of the mesh's group (``fn()`` itself without
    a group)."""
    if mesh is None or mesh.group is None:
        return [float(v) for v in fn()]
    vals = torch.zeros(size, dtype=torch.float64, device=mesh.devices[0])
    if mesh.rank == 0:
        vals = torch.tensor([float(v) for v in fn()], dtype=torch.float64, device=mesh.devices[0])
    return broadcast(vals, mesh.group).tolist()


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank of the mesh's group reaches this call (a sum
    of zeros on the mesh's device, so gloo and NCCL run it alike); no-op
    without a group."""
    if mesh is not None and mesh.group is not None:
        all_reduce(torch.zeros(1, device=mesh.devices[0]), mesh.group).cpu()


class RemoteTraceback(Exception):
    """The traceback of an exception raised in a rank's process."""


#: How long a rank of a launched run waits in one collective before it
#: fails: long enough for rank 0's evaluation over a whole val set while
#: the other ranks wait in its broadcast.
COLLECTIVE_TIMEOUT = datetime.timedelta(hours=6)


def _run_rank(fn, rank: int, world: int, backend: str, device: str, workdir: str, args) -> None:
    try:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                                world_size=world, timeout=COLLECTIVE_TIMEOUT)
        try:
            result = fn(make_mesh(devices=[dev], group=dist.group.WORLD), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(workdir, f"result{rank}.pt"))
    except BaseException as e:
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps((time.time(), e, tb))
        except Exception:  # an exception that does not pickle still reports its traceback
            payload = pickle.dumps((time.time(), None, tb))
        with open(os.path.join(workdir, f"error{rank}.pkl"), "wb") as f:
            f.write(payload)
        raise


def spawn(fn: Callable, world: int, backend: str = "gloo", devices: Optional[Sequence] = None,
          timeout: Optional[float] = None, args: Sequence = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world`` processes, one a rank, each
    with a one-device mesh over ``devices[rank]`` (default ``cuda:<rank>``)
    and the launched group; returns the ranks' results in rank order.

    ``fn`` must be importable by name (the ``spawn`` start method pickles
    it).  The ranks meet through a ``file://`` store in a temporary
    directory, so concurrent launches never share a port.  ``timeout`` is
    a deadline for the whole run in seconds: past it every rank is stopped
    and ``TimeoutError`` raised; ``None`` (the default, for a training run
    of hours) waits for the ranks without one.  A rank that waits in one
    collective longer than :data:`COLLECTIVE_TIMEOUT` fails.  When a rank
    fails, the rest are stopped and the first failure's exception is
    raised here, its traceback chained as :class:`RemoteTraceback`."""
    devices = [f"cuda:{r}" for r in range(world)] if devices is None else [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="ctd_spawn_")
    procs = [ctx.Process(target=_run_rank, daemon=True,
                         args=(fn, r, world, backend, devices[r], workdir, tuple(args)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks not joined within {timeout} s (exit codes {codes})")
            time.sleep(0.02)
        if any(c != 0 for c in codes):
            _raise_first(workdir, codes)
        return [torch.load(os.path.join(workdir, f"result{r}.pt"), map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(10)
        shutil.rmtree(workdir, ignore_errors=True)


def _raise_first(workdir: str, codes: List[Optional[int]]) -> None:
    """Raise the earliest rank error recorded in ``workdir`` (the ranks'
    own pickles), else a ``RuntimeError`` naming the exit codes."""
    errors = []
    for r in range(len(codes)):
        path = os.path.join(workdir, f"error{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                errors.append((r,) + pickle.loads(f.read()))
    if not errors:
        raise RuntimeError(f"a rank exited without a result (exit codes {codes})")
    rank, _, exc, tb = min(errors, key=lambda e: e[1])
    cause = RemoteTraceback(f"rank {rank} of {len(codes)}:\n{tb}")
    if exc is None:
        raise RuntimeError(f"rank {rank} failed") from cause
    raise exc from cause
