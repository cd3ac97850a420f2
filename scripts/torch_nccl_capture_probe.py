#!/usr/bin/env python3
"""NCCL collectives inside a CUDA graph capture, in a process group of one
(one card):

    python scripts/torch_nccl_capture_probe.py            # bound to the card
    python scripts/torch_nccl_capture_probe.py lazy       # no device_id

Prints the versions, then captures and replays, each on a side stream in
``capture_error_mode="thread_local"`` after an eager warm-up, as
``core/decode_graph.CapturedStep`` does: an all-reduce and a list
all-gather over the world and over a ``new_group``; an all-reduce on a
group first used by the warm-up; a backward whose all-reduce runs on
autograd's thread; and 66 in-place all-reduces (a tp decode step's count),
timed eagerly and replayed.  PyTorch warns when a captured graph is empty
(an in-place all-reduce of one rank records nothing).  Exits nonzero
without a CUDA device.  Imports no JAX.
"""

import datetime
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist


def _port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def capture(fn):
    """(graph, the captured run's output) of ``fn`` after its eager run on
    the capture stream."""
    side, cur = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    return graph, out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        return a

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print("versions", sys.version.split()[0], torch.__version__,
          torch.version.cuda, torch.cuda.nccl.version(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lazy = sys.argv[1:] == ["lazy"]
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60),
        **({} if lazy else {"device_id": dev}))
    try:
        x = torch.arange(8, dtype=torch.float32, device=dev)
        for label, group in (("world", None),
                             ("new_group", dist.new_group([0]))):
            def step():
                y = x * 2
                dist.all_reduce(y, group=group)
                parts = [torch.empty_like(y)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, y, group=group)
                return torch.cat(parts)
            graph, out = capture(step)
            x.add_(1)
            graph.replay()
            torch.cuda.synchronize()
            print(label, "replay equal:", torch.equal(out, x * 2),
                  flush=True)
        fresh = dist.new_group([0])
        capture(lambda: dist.all_reduce(x * 3, group=fresh))
        print("a group first used by the warm-up: captured", flush=True)
        w = torch.randn(64, 64, device=dev, requires_grad=True)
        inp = torch.randn(16, 64, device=dev)

        def train():
            h = _Copy.apply(inp) @ w
            (gw,) = torch.autograd.grad((h * h).sum(), [w])
            return gw
        graph, out = capture(train)
        want = train()
        graph.replay()
        torch.cuda.synchronize()
        print("autograd-thread all-reduce: replay equal:",
              torch.equal(out, want), flush=True)
        buf = torch.randn(4096, device=dev, dtype=torch.bfloat16)

        def many():
            for _ in range(66):
                dist.all_reduce(buf)
        graph, _ = capture(many)
        for name, fn in (("eager", many), ("replay", graph.replay)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            print(name, "ms per 66 all-reduces",
                  (time.perf_counter() - t0) / 20 * 1e3, flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
