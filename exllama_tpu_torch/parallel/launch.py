"""Start a world of ranks on this machine and collect what each returns.

The port's own helper (the JAX package, single-controller, needs none):
``run_world("package.module:function", n, args, backend=...)`` spawns
``n`` processes
with ``torch.multiprocessing`` (``spawn``), joins them into one
``torch.distributed`` world on a file store, calls the function on each
(``function(*args)``; ``torch.distributed.get_rank()`` tells it which rank
it is) and returns the ranks' results in rank order. The function must be
importable by name from the package, so a rank imports only the port (a
test module would drag in JAX); each rank runs on one torch thread. As
for any ``spawn`` start, the caller's main module must be safe to import
(its work under ``if __name__ == "__main__"``). A rank
that raises fails the whole call with its traceback, after the other ranks
are stopped. ``backend`` has no default: the caller names it, ``"gloo"``
(CPU tensors, and several ranks on one card) or ``"nccl"`` (one card a
rank).
"""

from __future__ import annotations

import importlib
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(rank, world, target, args, backend, store_path, results,
               wait):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from exllama_tpu_torch.parallel.multihost import initialize

        initialize(world_size=world, rank=rank, backend=backend,
                   store=dist.FileStore(store_path, world), timeout=wait)
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(*args)
        results.put((rank, True, out))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:       # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))


def run_world(target: str, world: int, args=(), *, backend: str,
              timeout: float = 900.0, collective_timeout: float = None
              ) -> list:
    """``target`` ("module:function") on each of ``world`` fresh ranks;
    returns [result of rank 0, ..., rank world-1]. ``timeout``: seconds for
    the whole call; ``collective_timeout``: for one collective (the
    backend's default otherwise)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="exl_world_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, target, tuple(args), backend,
                               store_path, results, collective_timeout),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {target} died "
                                       f"(exit {procs[dead[0]].exitcode})")
                if time.monotonic() > deadline:
                    silent = sorted(set(range(world)) - set(out))
                    raise TimeoutError(f"{target}: ranks {silent} gave "
                                       f"nothing in {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {target} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
