"""One process a card for the cells that take several: ``spawn`` starts
``world`` processes, each in a process group of its own making (NCCL over
``tcp://localhost:<free port>`` on card ``cuda:<rank>``, or gloo on the CPU
for tests) and calls ``fn(rank, group, device, *args)`` in each; it returns
when every rank has, and raises if one failed."""

from __future__ import annotations

import socket
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn, world: int, device_type: str, port: int, args: tuple) -> None:
    sys.path.insert(0, str(ROOT))
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        kw = {"device_id": device}
    else:
        device, kw = torch.device("cpu"), {}
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, **kw)
    try:
        fn(rank, dist.group.WORLD, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device_type: str, *args) -> None:
    """``fn(rank, group, device, *args)`` on ``world`` ranks (``fn`` must be
    importable by name: the ranks are fresh interpreters)."""
    torch.multiprocessing.start_processes(
        _entry, args=(fn, world, device_type, free_port(), args), nprocs=world,
        start_method="spawn")
