"""Ranks of the port's mesh routes on torch.distributed — the counterpart
of cmsbwt_tpu/parallel/distributed.py, plus what the JAX package's single
process has without asking: every local device in one program.

A mesh route (parallel/sharded_merge.py, parallel/mesh.py,
parallel/sharded_index.py) runs one rank per process, each on its own
device: ``cuda:LOCAL_RANK`` with NCCL, or the CPU with gloo. NCCL is the
only backend on ``cuda`` and gloo the only one on ``cpu``.

Ranks come to be in one of two ways:

* under a launcher, every process runs the same program and is one rank:
  :func:`maybe_initialize` reads ``CMSBWT_COORDINATOR`` (``host:port``,
  or a ``tcp://`` / ``file://`` URL), ``CMSBWT_NUM_PROCESSES`` and
  ``CMSBWT_PROCESS_ID`` (the JAX package's variables), or torchrun's
  ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` (and
  ``LOCAL_RANK`` for the card);
* without one, :func:`run` makes the calling process rank 0 and starts
  the other ranks itself (``torch.multiprocessing``, spawn), R of them:
  the visible cards on ``cuda`` (or ``n_devices``), ``n_devices`` (default
  1) on ``cpu``. They rendezvous through a ``file://`` store in a fresh
  temporary directory, run one mesh function and exit.

A mesh function is ``fn(ranks, inputs)``: rank 0 holds ``inputs`` (under a
launcher every rank does, and only rank 0's are read), the started ranks
get None and receive what they need from rank 0 by collectives; rank 0
gets the result, the others None. The group has a timeout
(``CMSBWT_DIST_TIMEOUT`` seconds, default 600), so a lost rank ends the
run with an error instead of a hang; an exception on any rank is raised
again in rank 0, and nothing catches it.
"""
from __future__ import annotations

import datetime
import os
import pathlib
import shutil
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Ranks:
    """This process's place in the group: its rank, the group's size R and
    the device its shards live on."""

    rank: int
    size: int
    device: torch.device

    def gidx(self, local: int) -> torch.Tensor:
        """Global row index (int64) of each of this rank's ``local`` rows
        (shard r owns rows [r*local, (r+1)*local))."""
        return torch.arange(self.rank * local, (self.rank + 1) * local,
                            dtype=torch.int64, device=self.device)


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("CMSBWT_DIST_TIMEOUT", "600")))


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"mesh routes run on cuda or cpu, not {device_type!r}")


def _init(url: str, world: int, rank: int, device_type: str,
          local_rank: int | None) -> None:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh rank on cuda needs a CUDA device, and "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(local_rank if local_rank is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(_backend(device_type), init_method=url,
                            world_size=world, rank=rank, timeout=_timeout())


def maybe_initialize(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cpu") -> bool:
    """Join the launcher's group if one is configured (arguments, the
    CMSBWT_* variables, or torchrun's); True when a group is (already) up.
    ``device`` picks the backend: NCCL on ``cuda`` (this process's card is
    ``cuda:LOCAL_RANK``), gloo on ``cpu``."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("CMSBWT_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("CMSBWT_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("CMSBWT_PROCESS_ID")
    if coordinator is None and num_processes is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
        num_processes = _env_int("WORLD_SIZE")
        process_id = _env_int("RANK")
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a launcher's group needs a coordinator, the number of processes "
            "and this process's id (CMSBWT_COORDINATOR, CMSBWT_NUM_PROCESSES, "
            "CMSBWT_PROCESS_ID)")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    _init(url, num_processes, process_id, torch.device(device).type,
          _env_int("LOCAL_RANK"))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def current(device) -> Ranks:
    """This process's Ranks in the initialized group, on ``device``'s type;
    the group's backend must be the one that type takes."""
    dev_type = torch.device(device).type
    if dist.get_backend() != _backend(dev_type):
        raise RuntimeError(
            f"the process group runs {dist.get_backend()}, and a mesh route "
            f"on {dev_type} needs {_backend(dev_type)}")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    return Ranks(dist.get_rank(), dist.get_world_size(), dev)


def n_ranks(device, n_devices: int | None = None) -> int:
    """The R a mesh route on ``device`` runs with: the launcher's world
    when a group is up, else ``n_devices``, else the visible cards on
    ``cuda`` and 1 on ``cpu``."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh route on cuda needs a CUDA device, and "
                               "torch.cuda.is_available() is False")
        return n_devices or torch.cuda.device_count()
    return n_devices or 1


# rank 0's record of its last run(): the ranks, the seconds to start them
# and form the group, the seconds of the mesh function, and each rank's
# peak device bytes on cuda (torch.cuda.max_memory_allocated, one
# all_gather after the function)
LAST_RUN: dict = {}


def _sync(g: Ranks) -> None:
    """Every rank has reached this point (a one-element all_reduce: gloo's
    barrier waits out a fixed delay)."""
    t = torch.zeros(1, device=g.device)
    dist.all_reduce(t)
    if g.device.type == "cuda":
        torch.cuda.synchronize(g.device)


def _peaks(g: Ranks):
    if g.device.type != "cuda":
        return None
    if g.size == 1:     # no collective: NCCL would build a communicator
        return [torch.cuda.max_memory_allocated(g.device)]
    out = torch.empty(g.size, dtype=torch.int64, device=g.device)
    dist.all_gather_into_tensor(out, torch.tensor(
        [torch.cuda.max_memory_allocated(g.device)], device=g.device))
    return out.tolist()


def _worker(i: int, world: int, url: str, device_type: str, fn,
            threads: int) -> None:
    torch.set_num_threads(threads)
    pathlib.Path(url[len("file://"):] + f".up{i + 1}").touch()
    _init(url, world, i + 1, device_type, i + 1)
    try:
        g = current(device_type)
        if world > 1:
            _sync(g)
        fn(g, None)
        _peaks(g)
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, url: str, device_type: str):
    """Start ranks 1..world-1 of ``fn`` (torch.multiprocessing, spawn);
    returns the context to join."""
    import torch.multiprocessing as mp
    return mp.start_processes(
        _worker, args=(world, url, device_type, fn, torch.get_num_threads()),
        nprocs=world - 1, join=False, start_method="spawn")


def _await_ranks(ctx, url: str, world: int) -> None:
    """Wait until every started rank is up (has imported the port and
    marked the store's directory), raising a rank's own error if it died
    first: the rendezvous itself would wait out the whole timeout."""
    deadline = time.monotonic() + _timeout().total_seconds()
    marks = [pathlib.Path(url[len("file://"):] + f".up{r}")
             for r in range(1, world)]
    while not all(m.exists() for m in marks):
        if ctx.join(0.05):
            raise RuntimeError("the started ranks exited before the group "
                               "formed")
        if time.monotonic() > deadline:
            raise TimeoutError("the started ranks did not come up within "
                               f"{_timeout()}")


def run(fn, inputs, device, n_devices: int | None = None):
    """``fn(ranks, inputs)`` on every rank of a mesh route on ``device``:
    in the launcher's group when one is up, else in a group of
    n_ranks(device, n_devices) ranks that this process leads and ends
    (a one-rank group included). Returns rank 0's result, None elsewhere."""
    device = torch.device(device)
    if dist.is_initialized():
        return fn(current(device), inputs)
    world = n_ranks(device, n_devices)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks on cuda need {world} cards; "
                         f"{torch.cuda.device_count()} are visible")
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="cmsbwt_ranks_")
    url = "file://" + os.path.join(store, "rendezvous")
    ctx = _spawn(fn, world, url, device.type) if world > 1 else None
    try:
        if ctx is not None:
            _await_ranks(ctx, url, world)
        _init(url, world, 0, device.type,
              device.index if device.index is not None else
              (torch.cuda.current_device() if device.type == "cuda" else None))
        try:
            g = current(device)
            if world > 1:
                _sync(g)            # every rank up: the rest is the work
            t1 = time.perf_counter()
            out = fn(g, inputs)
            t2 = time.perf_counter()
            LAST_RUN.clear()
            LAST_RUN.update(ranks=world, setup_s=t1 - t0, work_s=t2 - t1,
                            peak_bytes=_peaks(g))
        except BaseException as e:
            if ctx is not None:
                try:              # a started rank's own error, if any
                    ctx.join(10)
                except Exception as rank_error:
                    raise rank_error from e
            raise
        finally:
            dist.destroy_process_group()
        while ctx is not None and not ctx.join():
            pass
        ctx = None
        return out
    finally:
        if ctx is not None:       # rank 0 failed: the others cannot finish
            for p in ctx.processes:
                p.terminate()
                p.join(30)
        shutil.rmtree(store, ignore_errors=True)
