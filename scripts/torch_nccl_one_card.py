#!/usr/bin/env python3
"""Two NCCL ranks on one CUDA card: what NCCL answers.

    python3 scripts/torch_nccl_one_card.py

Starts two processes (start method spawn), both on ``cuda:0``, joins them
in an NCCL process group over 127.0.0.1 (60 s timeout) and runs one
``all_reduce``.  Prints, per rank, the result or the error it raised (and,
with ``NCCL_DEBUG=WARN``, which it sets, NCCL's own reason), and exits 0
either way: the script records the behaviour that decides why the
port's sharded programs put several ranks on one card over Gloo.
"""

import os
import socket
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, port, queue):
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2, timeout=timedelta(seconds=60))
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        queue.put((rank, f"all_reduce gave {x.tolist()}"))
        dist.destroy_process_group()
    except Exception as exc:  # the answer this script exists to record
        queue.put((rank, f"{type(exc).__name__}: {exc}".strip()[-2000:]))
        traceback.print_exc()


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_nccl_one_card: no CUDA device")
    os.environ.setdefault("NCCL_DEBUG", "WARN")   # NCCL prints why it refuses
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, port, queue)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    answers = {}
    while not queue.empty():
        rank, msg = queue.get()
        answers[rank] = msg
    for r in range(2):
        print(f"rank {r} (exit code {procs[r].exitcode}): {answers.get(r, 'no answer')}")


if __name__ == "__main__":
    main()
