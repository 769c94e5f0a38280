"""Process-group helpers — port of `bundler_sfm_tpu/parallel/mesh.py`.

The JAX package runs one process over a device mesh (`shard_map` with XLA
collectives, `jax.distributed` across hosts).  Here one process is one
rank on one device, joined by `torch.distributed`: `psum` becomes
`all_reduce`, `pmax` `all_reduce(MAX)`, a tiled `all_gather` `all_gather` +
`cat`, `ppermute` `batch_isend_irecv`; `globalize` becomes "every rank
builds the same host array and keeps its shard", `fetch` an `all_gather`
to every rank.

The backend follows from the device: NCCL for CUDA, gloo for the CPU.  A
gloo group on CUDA tensors (ranks that share one card, where NCCL refuses
a second rank) is used only when asked for by name; gloo has no CUDA
send/recv/all_gather, so `Mesh` then moves every collective's tensor to the
host and back (`Mesh._wire`).  Every group is created with a timeout, so
ranks that fall out of step fail instead of hanging.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import queue
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bundler_sfm_tpu_torch.utils.device import resolve_device

# Seconds a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT_S = 300.0
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _timeout(seconds: Optional[float]) -> datetime.timedelta:
    return datetime.timedelta(seconds=DEFAULT_TIMEOUT_S if seconds is None
                              else seconds)


def _rank_device(device, local_rank: int) -> torch.device:
    """`device`, with a bare "cuda" mapped to this rank's card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


class Mesh:
    """One rank of a process group and its device.

    Collectives return new tensors on the caller's device and dtype; bool
    tensors travel as uint8.  On a gloo group with a CUDA device each
    collective goes through host memory (gloo implements only all_reduce
    and broadcast for CUDA tensors); the choice is made once, from the
    group's backend."""

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self._via_host = self.backend == "gloo" and self.device.type == "cuda"

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh contiguous copy of x as the collective sends it."""
        dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
        dev = torch.device("cpu") if self._via_host else x.device
        return x.detach().to(device=dev, dtype=dtype, copy=True).contiguous()

    @staticmethod
    def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return y.to(device=like.device, dtype=like.dtype)

    def _reduce(self, x, op):
        w = self._wire(x)
        dist.all_reduce(w, op=op, group=self.group)
        return self._back(w, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the ranks (`jax.lax.psum`)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max of x over the ranks (`jax.lax.pmax`)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def psum_all(self, *xs: torch.Tensor):
        """psum of several tensors of one dtype in one all_reduce."""
        flat = self.psum(torch.cat([x.reshape(-1) for x in xs]))
        out, at = [], 0
        for x in xs:
            out.append(flat[at:at + x.numel()].reshape(x.shape))
            at += x.numel()
        return tuple(out)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's x concatenated along `dim`, in rank order (the tiled
        `jax.lax.all_gather`); every rank's x has the same shape."""
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return self._back(torch.cat(parts, dim), x)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """x of rank (rank + 1) % size: each rank sends to (rank − 1) % size,
        as the JAX ring's `ppermute` with perm [(i, (i − 1) % D)].  With one
        rank it returns x itself and sends nothing."""
        if self.size == 1:
            return x
        w = self._wire(x)
        out = torch.empty_like(w)
        src = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        dst = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, dst, self.group),
            dist.P2POp(dist.irecv, out, src, self.group)])
        for r in reqs:
            r.wait()
        return self._back(out, x)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s x on every rank."""
        w = self._wire(x)
        dist.broadcast(w, dist.get_global_rank(self.group, src),
                       group=self.group)
        return self._back(w, x)

    def barrier(self) -> None:
        """Returns once every rank has reached it."""
        self.psum(torch.zeros(1, device=self.device))

    def check_replicated(self, what: str, *arrays) -> None:
        """Raise unless every rank holds the same bytes in `arrays` (numpy
        arrays or tensors): rank 0 broadcasts a digest and each rank
        compares its own with it."""
        h = hashlib.sha1()
        for a in arrays:
            a = a.detach().cpu().numpy() if torch.is_tensor(a) else \
                np.asarray(a)
            h.update(str((a.dtype, a.shape)).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        mine = torch.tensor([int.from_bytes(h.digest()[:7], "little")],
                            dtype=torch.int64, device=self.device)
        if not torch.equal(self.broadcast(mine), mine):
            raise RuntimeError(f"rank {self.rank} of {self.size}: {what} "
                               "differ from rank 0's; the ranks drifted apart")


def _torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def make_mesh(num_devices: Optional[int] = None, device="cuda",
              timeout: Optional[float] = None) -> Mesh:
    """The mesh of the default process group.

    Joins the group if one is initialized; else initializes it from
    torchrun's environment (`env://`), or makes a one-rank group, with the
    device's backend (`default_backend`) and `timeout` seconds (default
    DEFAULT_TIMEOUT_S); an existing group keeps its own.  `num_devices` 0
    or None means every rank of the group; any other count must equal the
    group's size (the JAX package's `make_mesh` slices `devs[:n]`; here no
    rank is left out silently).  A bare "cuda" means this rank's card
    (LOCAL_RANK, else the rank modulo the card count)."""
    rank = dist.get_rank() if dist.is_initialized() else \
        int(os.environ.get("RANK", 0))
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if _torchrun():
            dist.init_process_group(default_backend(dev),
                                    init_method="env://",
                                    timeout=_timeout(timeout))
        else:
            dist.init_process_group(default_backend(dev),
                                    store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=_timeout(timeout))
    size = dist.get_world_size()
    if num_devices not in (None, 0) and num_devices != size:
        raise ValueError(f"make_mesh: {num_devices} devices asked for, the "
                         f"process group has {size} ranks")
    return Mesh(dist.group.WORLD, dev)


def initialize_multihost(coordinator: str, num_processes: int,
                         process_id: int, device="cuda") -> Mesh:
    """Join a group of `num_processes` ranks (one per GPU, across hosts)
    whose rank 0 listens at `coordinator` ("host:port"): sets torchrun's
    RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT and returns make_mesh's
    mesh over them."""
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs num_processes and "
                         "process_id")
    resolve_device(device)
    addr, port = coordinator.rsplit(":", 1)
    os.environ.update(RANK=str(process_id), WORLD_SIZE=str(num_processes),
                      MASTER_ADDR=addr, MASTER_PORT=port)
    return make_mesh(num_processes, device)


def run_entry(argv: Sequence[str], parse: Callable, run: Callable) -> int:
    """A command-line entry point under the launch rules; its exit code.

    `parse(argv)` gives the options (num_devices, device and the multihost
    options); `run(options, mesh)` runs the program on one rank, with mesh
    None on one device.  With --multihost_coordinator this process joins
    that group.  Inside a process group (torchrun, or one set up by the
    caller) it runs as this process's rank, the mesh spanning every rank
    when num_devices is 1 (as the JAX package's multihost run spans every
    host).  Else num_devices other than 1 starts that many ranks (`launch`;
    `parse` and `run` must pickle) and returns the largest exit code; 1
    runs on one device."""
    argv = list(argv)
    args = parse(argv)
    if args.multihost_coordinator:
        initialize_multihost(args.multihost_coordinator, args.num_processes,
                             args.process_id, device=args.device)
    if not (dist.is_initialized() or _torchrun()):
        if args.num_devices == 1:
            return run(args, None)
        return max(launch(_entry_rank, args.num_devices, args.device,
                          args=(argv, parse, run)))
    return run(args, make_mesh(0 if args.num_devices == 1
                               else args.num_devices, args.device))


def _entry_rank(mesh: Mesh, argv, parse: Callable, run: Callable) -> int:
    """One rank of an entry point started by `run_entry`."""
    return run(parse(argv), mesh)


def _launched(rank: int, fn: Callable, args: Sequence, size: int,
              devices: Sequence[str], backend: str, store_path: str,
              results) -> None:
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size,
                            timeout=_timeout(None))
    out = fn(Mesh(dist.group.WORLD, dev), *args)
    # By value: torch's queue would pass tensors as shared-memory handles
    # that die with this process.
    results.put((rank, pickle.dumps(out)))
    dist.destroy_process_group()


def launch(fn: Callable, num_devices: int, device="cuda",
           backend: Optional[str] = None, args: Sequence = ()) -> list:
    """Run fn(mesh, *args) on `num_devices` new ranks and return their
    results in rank order.

    The ranks are spawned processes (`torch.multiprocessing`, spawn
    context) that meet at a FileStore in a temporary directory.  On "cuda"
    rank r runs on cuda:r (0 = every visible card) and more ranks than
    cards raise; on an indexed card ("cuda:0") every rank shares it, which
    only a gloo group allows, so `backend="gloo"` must be given; on the CPU
    the ranks use gloo.  `fn` and `args` must pickle, and so must what fn
    returns (tensors in it come back on the device they were on: return
    CPU tensors or numpy).  A rank that fails stops the others and raises
    here; a collective that waits DEFAULT_TIMEOUT_S for the others fails
    its rank."""
    dev = resolve_device(device)
    if num_devices == 0:
        if dev.type != "cuda":
            raise ValueError("launch: num_devices=0 means every visible card")
        num_devices = torch.cuda.device_count()
    if num_devices < 1:
        raise ValueError(f"launch: num_devices={num_devices}")
    backend = backend or default_backend(dev)
    if dev.type == "cuda" and dev.index is None:
        if num_devices > torch.cuda.device_count():
            raise ValueError(f"launch: {num_devices} ranks asked for, "
                             f"{torch.cuda.device_count()} cards visible")
        devices = [f"cuda:{r}" for r in range(num_devices)]
    else:
        if backend == "nccl" and num_devices > 1:
            raise ValueError("launch: ranks sharing one card need "
                             "backend='gloo' (NCCL allows one rank a card)")
        devices = [str(dev)] * num_devices
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="bundler_mesh_") as tmp:
        procs = torch.multiprocessing.start_processes(
            _launched, args=(fn, tuple(args), num_devices, devices, backend,
                             os.path.join(tmp, "store"), results),
            nprocs=num_devices, join=False, start_method="spawn")
        # Drain the queue while joining: a rank blocks on exit until what it
        # put is read.  join() raises when a rank fails (and stops the rest).
        done = False
        while not done or len(got) < num_devices:
            if not done:
                done = procs.join(timeout=0.05)
            if len(got) == num_devices:
                continue
            try:
                rank, out = results.get(timeout=5.0 if done else 0.05)
                got[rank] = pickle.loads(out)
            except queue.Empty:
                if done:
                    missing = sorted(set(range(num_devices)) - set(got))
                    raise RuntimeError(f"launch: ranks {missing} exited "
                                       "without a result")
    return [got[r] for r in range(num_devices)]
