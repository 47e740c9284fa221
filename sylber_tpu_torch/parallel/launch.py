"""Start the ranks of a small world on this machine.

:func:`spawn` runs ``fn(rank, world, *args)`` in ``world`` fresh processes
(``torch.multiprocessing``, "spawn": each imports only what ``fn``'s module
imports) and returns what each rank returned. The rendezvous is a
``FileStore`` in a new directory under ``store_dir``, so concurrent worlds
(test workers, say) never race for a TCP port. Used by the tests (gloo on
the CPU) and by ``chip_smoke.py`` (gloo or NCCL on the card).
"""

from __future__ import annotations

import faulthandler
import os
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist


def _child(rank: int, fn: Callable, world: int, root: str, backend: str, args: tuple,
           init: bool) -> None:
    faulthandler.enable()  # a rank killed by a signal still prints where it was
    torch.set_num_threads(1)  # the ranks share the host's cores
    if backend == "nccl":  # one rank a GPU
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if init:
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(root, f"result_{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """Ranks started by :func:`start`; :meth:`results` waits for them."""

    def __init__(self, context, root: str, world: int):
        self.context, self.root, self.world = context, root, world

    def results(self) -> List[Any]:
        """The ranks' results in rank order; a failing rank raises here."""
        while not self.context.join():
            pass
        return [torch.load(os.path.join(self.root, f"result_{r}.pt"), weights_only=False)
                for r in range(self.world)]


def start(fn: Callable, world: int, store_dir: str, *args: Any, backend: str = "gloo",
          init: bool = True) -> World:
    """Start ``fn(rank, world, *args)`` on ``world`` ranks joined in one
    process group (``backend``; none with ``init=False``, where ``fn``
    forms its own) and return at once. ``fn`` must be importable by name
    and return something ``torch.save`` takes; each rank runs one intra-op
    thread (NCCL ranks on ``cuda:rank``)."""
    os.makedirs(store_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="world_", dir=store_dir)
    context = torch.multiprocessing.start_processes(
        _child, args=(fn, world, root, backend, args, init), nprocs=world,
        join=False, start_method="spawn")
    return World(context, root, world)


def spawn(fn: Callable, world: int, store_dir: str, *args: Any, **kwargs: Any) -> List[Any]:
    """:func:`start`, then the ranks' results in rank order."""
    return start(fn, world, store_dir, *args, **kwargs).results()
