"""Which ``torch.distributed`` gloo calls take CUDA tensors on this machine.

Each case runs in a world of its own of two rank processes on GPU 0, so a
case that aborts its processes (gloo handing a device pointer to a socket
call) ends that world only. The cases are the calls the port's mesh
collectives make (``ray_tpu_torch/parallel/collective.py``): all-reduce,
all-gather, reduce-scatter, and a ring exchange (each rank's tensor to the
next rank) both as an ``all_to_all_single`` with one non-empty split and
through ``batch_isend_irecv``, in f32 and bf16; the last again from host
tensors. Prints one line a case, then a JSON object of the outcomes.

    python3 tools/probe_gloo_cuda.py
"""

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta

CASES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single_ring", "batch_isend_irecv",
         "batch_isend_irecv_host")
DTYPES = ("float32", "bfloat16")
WORLD = 2


def rank_main(case: str, dtype_name: str, addr: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=WORLD, rank=rank,
                            timeout=timedelta(seconds=60))
    dtype = getattr(torch, dtype_name)
    dev = "cpu" if case.endswith("_host") else "cuda"
    x = torch.full((1024,), float(rank + 1), dtype=dtype, device=dev)
    if case == "all_reduce":
        dist.all_reduce(x)
        want = torch.full_like(x, sum(range(1, WORLD + 1)))
        got = x
    elif case == "all_gather_into_tensor":
        got = x.new_empty(WORLD * x.numel())
        dist.all_gather_into_tensor(got, x)
        want = torch.cat([torch.full_like(x, r + 1) for r in range(WORLD)])
    elif case == "reduce_scatter_tensor":
        got = x.new_empty(x.numel() // WORLD)
        dist.reduce_scatter_tensor(got, x)
        want = torch.full_like(got, sum(range(1, WORLD + 1)))
    elif case == "all_to_all_single_ring":
        n = x.numel()
        dst, src = (rank + 1) % WORLD, (rank - 1) % WORLD
        got = torch.zeros_like(x)
        dist.all_to_all_single(
            got, x, output_split_sizes=[n * (r == src) for r in range(WORLD)],
            input_split_sizes=[n * (r == dst) for r in range(WORLD)])
        want = torch.full_like(x, src + 1)
    else:
        got = torch.zeros_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % WORLD),
               dist.P2POp(dist.irecv, got, (rank - 1) % WORLD)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        want = torch.full_like(x, (rank - 1) % WORLD + 1)
    if dev == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"rank {rank}: wrong result {got[:4].tolist()}")
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    worlds = {}
    for case in CASES:
        for dt in DTYPES:
            addr = f"127.0.0.1:{free_port()}"
            worlds[f"{case}_{dt}"] = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", case,
                 dt, addr, str(r)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outcome = {}
    for name, procs in worlds.items():
        rcs, tails = [], []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            rcs.append(p.returncode)
            tails.append(out.strip().splitlines()[-1:] if out.strip() else [])
        ok = rcs == [0] * WORLD
        outcome[name] = "ok" if ok else f"rc {rcs}"
        print(f"{name}: {'ok' if ok else 'FAILED'} rcs {rcs}"
              + ("" if ok else f" last lines {tails}"), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "outcome": outcome}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--rank":
        rank_main(sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]))
    else:
        sys.exit(main())
