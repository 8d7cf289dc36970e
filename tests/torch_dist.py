"""Spawned gloo ranks on the CPU for the port's sharded-step tests.

:func:`spawn` starts ``world`` processes (the ``spawn`` method: a fresh
interpreter each, torch on one thread, as ``torch_one_thread`` sets the
test files), joins them into a gloo process group through a
``FileStore`` under the test's ``tmp_path`` (no fixed port: the tests
run in parallel workers), runs ``fn(rank, world, *args)`` on each and
returns each rank's result, passed back through ``torch.save``. ``fn``
is a module-level function of a module that imports no JAX (the ranks
do not need it). :func:`regroup` starts a fresh group of another size
inside ranks that left theirs, for a restore at another world size.
"""

from __future__ import annotations

import multiprocessing
import os
import uuid

import torch
import torch.distributed as dist


def init_group(store_path: str, rank: int, world: int) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def regroup(store_path: str, rank: int, world: int) -> None:
    """Leave the current group and join a new one of ``world`` ranks."""
    if dist.is_initialized():
        dist.destroy_process_group()
    init_group(store_path, rank, world)


def _entry(fn, rank, world, store_path, out_path, args):
    torch.set_num_threads(1)
    init_group(store_path, rank, world)
    try:
        result = fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, out_path)


def spawn(fn, world: int, tmp_path, *args, timeout: float = 300.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process of a gloo group of ``world`` ranks."""
    ctx = multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex
    store = os.path.join(str(tmp_path), f"store_{tag}")
    outs = [os.path.join(str(tmp_path), f"out_{tag}_{r}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, outs[r],
                                              args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"ranks exited with {codes} "
                           f"({len(alive)} killed at the time limit)")
    return [torch.load(o, weights_only=False) for o in outs]
