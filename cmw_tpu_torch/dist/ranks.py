"""One function run on n ranks of a `torch.distributed` process group.

`run_ranks(n, target, kwargs, device)` runs rank 0 in the calling process
and ranks 1..n-1 as processes of their own (`python -m
cmw_tpu_torch.dist.ranks`), joined by a TCP rendezvous on a free local port.
On the card each rank takes card `rank` and the NCCL backend, and n more
than the cards present raises; on the CPU (device "cpu") the ranks use gloo.
`target` ("module:function") is called as target(rank=..., world=...,
device=..., **kwargs); rank 0's return value is returned. Every process it
starts has ended when it returns.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank(rank: int, world: int, init: str, target: str, kwargs: dict, device: str):
    cuda = device != "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        module, fn = target.split(":")
        return getattr(importlib.import_module(module), fn)(
            rank=rank, world=world, device=f"cuda:{rank}" if cuda else "cpu", **kwargs)
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, target: str, kwargs: dict, device: str = "cuda"):
    if device != "cpu" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards, {torch.cuda.device_count()} present (device='cpu' runs them "
                           f"on the CPU)")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    init = f"tcp://127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    spec = json.dumps({"world": n, "init": init, "target": target, "kwargs": kwargs, "device": device})
    logs = [tempfile.TemporaryFile("w+") for _ in range(1, n)]
    procs = [subprocess.Popen([sys.executable, "-m", "cmw_tpu_torch.dist.ranks", str(r), spec], env=env, stdout=log,
                              stderr=subprocess.STDOUT, text=True) for r, log in zip(range(1, n), logs)]
    try:
        result = _rank(0, n, init, target, kwargs, device)
        for r, (p, log) in enumerate(zip(procs, logs), start=1):
            if p.wait(timeout=600):
                log.seek(0)
                raise RuntimeError(f"rank {r} failed ({p.returncode}):\n{log.read()[-4000:]}")
        return result
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="one rank of run_ranks (not for direct use)")
    p.add_argument("rank", type=int)
    p.add_argument("spec")
    a = p.parse_args()
    s = json.loads(a.spec)
    _rank(a.rank, s["world"], s["init"], s["target"], s["kwargs"], s["device"])
