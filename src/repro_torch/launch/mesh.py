"""Production meshes, and a launcher that starts a mesh's ranks — the
counterpart of ``repro.launch.mesh``.

``make_production_mesh`` and ``make_local_mesh`` build the reference's
shapes and names over the live process group (``compat.make_mesh``).

The reference needs no launcher: one JAX process drives every device of
a host.  A rank of the port is a process, so ``run_ranks`` is the port's
plumbing, not a feature of the system: it starts ``world`` local ranks
(the ``spawn`` start method, which CUDA needs), joins them into one
process group over a ``FileStore`` in a temporary directory, runs a
function on each and returns rank 0's result.  A rank that raises, dies
or outlives the timeout makes it kill every rank and raise.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

from repro_torch import compat


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes, device=device)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None):
    """A (data, model) mesh over the live process group."""
    return compat.make_mesh((data, model), ("data", "model"), device=device)


def _rank_main(fn, args_file: str, rank: int, world: int, backend: str,
               store: str, threads: int, results) -> None:
    import pickle
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out if rank == 0 else None))
    except BaseException:          # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))
        raise


def run_ranks(fn, world: int, *, backend: str, args: tuple = (),
              timeout: float = 120.0):
    """Run ``fn(*args)`` on ``world`` new ranks of one process group
    (``backend``: ``gloo`` or ``nccl``, the caller's choice) and return
    rank 0's result.  ``fn`` must be importable by name (a module-level
    function) and its result picklable.  Raises, after killing every
    rank, when a rank fails or the ranks outlive ``timeout`` seconds."""
    import pickle
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    threads = max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # The arguments go through a file: a start's pickle that outgrows
        # the pipe's buffer holds the parent until that rank has booted
        # and read it, so the ranks would start one after another.
        args_file = os.path.join(tmp, "args.pkl")
        with open(args_file, "wb") as f:
            pickle.dump(args, f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, args_file, rank, world, backend,
                                   os.path.join(tmp, "store"), threads,
                                   results))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done, out, error = set(), None, None
        try:
            while len(done) < world and error is None:
                try:
                    rank, err, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode} and no result")
                    elif time.monotonic() > deadline:
                        error = (f"ranks {sorted(set(range(world)) - done)} "
                                 f"still running after {timeout:.0f} s")
                    continue
                done.add(rank)
                if err is not None:
                    error = f"rank {rank} failed:\n{err}"
                elif rank == 0:
                    out = value
            if error is None:
                for p in procs:
                    p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            results.close()
        if error is not None:
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                               f"world={world}): {error}")
        return out
