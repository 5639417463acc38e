"""A run of a cell over several cards: one process a card, joined by
``torch.distributed`` (NCCL on the cards; gloo and the CPU in the tests).

This process is rank 0: it spawns ranks 1 .. n-1, each of which loads the
same cell by name, and every rank then runs ``run.run_cell`` on its slab
with the group. Rank 0's result is the run's. Every spawned process is
joined before ``launch`` returns; one that fails fails the run.
"""

from __future__ import annotations

import multiprocessing as mp
import socket

import torch
import torch.distributed as dist

from edtbench import spec

JOIN_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank, world, port, backend, device_type):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")


def _cell(root, name, config):
    cell = spec.load(root, only=name)[name]
    if config is not None:
        cell.config = config
    return cell


def worker(rank, world, port, root, name, backend, device_type, config, job):
    """Rank ``rank`` > 0 of a run (a spawned process): ``job(cell, device,
    group)``."""
    torch.set_num_threads(2)
    device = _join(rank, world, port, backend, device_type)
    try:
        job(_cell(root, name, config), device, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def launch(root, name, world, job, backend="nccl", device_type="cuda",
           config=None, target=worker):
    """``job(cell, device, group)`` on each of ``world`` ranks of cell
    ``name``; rank 0's return. ``job`` is pickled to the spawned ranks (a
    module-level function, or a ``functools.partial`` of one); ``config``
    replaces the cell's configuration on every rank (the tests' sizes);
    ``target`` is the spawned ranks' entry."""
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, port, str(root), name, backend,
                               device_type, config, job))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        device = _join(0, world, port, backend, device_type)
        try:
            out = job(_cell(root, name, config), device, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"{len(failed)} of ranks 1-{world - 1} failed "
                           f"(exit codes {failed})")
    return out
