"""Process-group start-up and a launcher for N ranks.

PyTorch counterpart of the JAX package's `parallel/multihost.py`. The JAX
package initializes `jax.distributed` and then drives every chip from each
host; here every rank is a process, started by `torchrun` (which sets
MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK) or by `launch`
below, and `initialize` joins it to the default process group.

The backend is the caller's choice and is never switched: NCCL for CUDA
tensors with one rank per card, gloo for CPU tensors and for several ranks
that share one card (NCCL refuses two ranks on one GPU; gloo stages CUDA
tensors through the host). A failed initialization raises.

`launch` runs a function on N ranks in spawned processes, each joined to
a fresh group through a FileStore or TCP `init_method`, and returns the
ranks' results; it is the port's counterpart of the JAX tests' virtual
CPU mesh, and the tests, `apps/scaling_bench.py` and `chip_smoke.py` use
it. The function must be importable by name in a fresh interpreter.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "nccl",
               init_method: Optional[str] = None, timeout_s: float = 300.0) -> dict:
    """Join this process to the default process group, from explicit
    arguments (`coordinator_address` host:port or `init_method`, with
    `num_processes` and `process_id`) or from the torchrun environment. A
    process with neither is a single process and joins no group. Nothing
    happens when the group exists already.

    Returns {process_index, process_count, local_devices, global_devices,
    backend}: one device per rank (SPMD), so global_devices is the world
    size."""
    if not dist.is_initialized():
        env = os.environ
        if num_processes is None and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env["RANK"])
            if init_method is None and coordinator_address is None:
                init_method = "env://"
        if num_processes is not None:
            if init_method is None:
                if coordinator_address is None:
                    raise ValueError("initialize needs coordinator_address or init_method")
                init_method = f"tcp://{coordinator_address}"
            if process_id is None:
                raise ValueError("initialize needs process_id with num_processes")
            if backend == "nccl" and torch.cuda.is_available():
                local = int(os.environ.get("LOCAL_RANK", process_id))
                torch.cuda.set_device(local % torch.cuda.device_count())
            dist.init_process_group(backend, init_method=init_method, rank=process_id,
                                    world_size=num_processes,
                                    timeout=datetime.timedelta(seconds=timeout_s))
    if dist.is_initialized():
        index, count, name = dist.get_rank(), dist.get_world_size(), dist.get_backend()
    else:
        index, count, name = 0, 1, None
    return {"process_index": index, "process_count": count, "local_devices": 1,
            "global_devices": count, "backend": name}


def is_primary() -> bool:
    """True on the rank that writes artifacts and logs (rank 0, or the only
    process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown():
    """Leave the default process group, if this process is in one, after
    releasing the captured programs that sum over a group (a replay after
    the group is destroyed would fault)."""
    if dist.is_initialized():
        from stereo_orb_slam_torch.utils import programs

        programs.release_groups()
        dist.destroy_process_group()


def _rank_main(rank, world_size, backend, init_method, timeout_s, fn, args, results):
    try:
        initialize(init_method=init_method, num_processes=world_size, process_id=rank,
                   backend=backend, timeout_s=timeout_s)
        try:
            out = fn(rank, world_size, *args)
        finally:
            shutdown()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world_size: int, args=(), backend: str = "gloo",
           init_method: Optional[str] = None, timeout_s: float = 300.0) -> list:
    """Run fn(rank, world_size, *args) on `world_size` spawned ranks joined
    by `backend` and return the results in rank order (they must pickle).
    `init_method` defaults to a FileStore in a fresh temporary directory.
    Raises RuntimeError with the ranks' tracebacks when a rank fails, and
    TimeoutError, after stopping every rank, when the ranks do not all
    finish within `timeout_s` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        if init_method is None:
            init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, backend, init_method, timeout_s, fn, args,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got, errors = {}, []
        try:
            # Drain the queue before joining: a child blocks on a full pipe.
            # A failed rank ends the run: the others may wait in a collective.
            while len(got) < world_size and not errors:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"launch: {world_size} ranks did not finish in "
                                       f"{timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(remaining, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead and results.empty():
                        errors.append(f"rank {dead[0]} exited with code "
                                      f"{procs[dead[0]].exitcode} and no result")
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
            if not errors:
                for p in procs:
                    p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if errors:
            raise RuntimeError("launch: ranks failed\n" + "\n".join(errors))
        alive = [p.pid for p in procs if p.is_alive()]
        if alive:
            raise TimeoutError(f"launch: ranks {alive} did not exit")
    return [got[r] for r in range(world_size)]
