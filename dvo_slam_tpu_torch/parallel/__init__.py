"""Multi-process scale-out over ``torch.distributed`` (counterpart of
``dvo_slam_tpu/parallel/``, which shards over ``jax.sharding`` meshes).

The JAX package runs one program over a device mesh with named axes; here
every rank is a process with a ``DeviceMesh`` of the same two axes:

  * ``batch`` — independent pairs or sequences split over ranks
                (validation fleets, sequence fleets, graph edges);
  * ``pixel`` — a reference image's rows split over ranks, every sum of
                the IRLS linearization all-reduced over them
                (models/dense_tracker.py's ``pixel_group``).

``sharded`` holds the mesh, the sharded tracker, the validation fleet and
the edge-sharded graph assembly; ``batch_slam`` the sequence fleets. This
module starts the processes:

- ``spawn(fn, world_size, device)`` starts ``world_size`` ranks with
  ``torch.multiprocessing`` (the "spawn" start method), joins a process
  group in each and returns every rank's ``fn(rank, world_size, device,
  *args)``. It stops every rank it started, and raises if a rank fails or
  the world outlives its timeout.
- The backend is explicit and printed. On the CPU it is ``gloo``. On
  CUDA cards it is ``nccl`` with one rank per card when there are enough
  cards; with more ranks than cards, ranks share cards over ``gloo``
  (which carries CUDA tensors; NCCL refuses two ranks on one card).
  Nothing falls back to the CPU.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time

import torch

DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(world_size: int, device) -> str:
    """``gloo`` on the CPU; on CUDA ``nccl`` when every rank has a card of
    its own, else ``gloo`` (ranks sharing cards)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"parallel runs on cpu or cuda, not {device}")
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def rank_device(rank: int, device) -> torch.device:
    """The device of rank ``rank``: the CPU, or card ``rank % cards``."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init(rank: int, world_size: int, backend: str, init_method: str,
         timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group at ``init_method``,
    ``tcp://127.0.0.1:<port>`` (the same for every rank; ``free_port``
    finds one), with ``timeout_s`` for its collectives."""
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _worker(rank, fn, world_size, backend, init_method, device, args,
            out_dir, timeout_s):
    import torch.distributed as dist

    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # Ranks share the host's cores.
        torch.set_num_threads(1)
    init(rank, world_size, backend, init_method, timeout_s)
    try:
        out = fn(rank, world_size, dev, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world_size: int, device="cuda", args=(),
          timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` new
    processes joined in one process group; return the list of their
    results (picklable values, rank order).

    fn must be importable by name (a module-level function). device:
    "cpu", or "cuda" for rank r on card r % cards; the backend is
    ``backend_for(world_size, device)``. Raises if a rank raises (the
    others are stopped) or if the ranks have not all finished within
    ``timeout_s`` (all are killed)."""
    import torch.multiprocessing as mp

    backend = backend_for(world_size, device)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    where = str(device)
    if torch.device(device).type == "cuda":
        where = (f"{min(world_size, torch.cuda.device_count())} of "
                 f"{torch.cuda.device_count()} CUDA card(s)")
    print(f"parallel.spawn: {world_size} ranks over {backend} on {where} "
          f"({init_method})", flush=True)
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _worker, args=(fn, world_size, backend, init_method, device,
                           tuple(args), out_dir, timeout_s),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"parallel.spawn: {world_size} ranks still running "
                        f"after {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
