#!/usr/bin/env python3
"""Which collectives gloo takes on CUDA tensors, with two ranks on one card.

Run from the root of a checkout on a machine with a CUDA device:

    python3 tools/torch_port_gloo_cuda_probe.py

Two spawned ranks join a gloo process group (a file store) and each puts
its tensors on cuda:0.  For all_reduce, all_gather, broadcast and
all_gather_object the script prints whether gloo ran the collective on the
CUDA tensors and whether the result is right, then all_reduce and
all_gather through the port's collective wrapper (``parallel/mesh.Mesh``)
on a (2, 1) mesh.  The last line is one JSON object.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe():
    from playaid_core_torch.parallel.mesh import make_mesh

    rank, dev = dist.get_rank(), torch.device("cuda", 0)
    out = {}

    def attempt(name, fn, expected):
        try:
            got = fn()
            out[name] = "right" if got == expected else f"wrong: {got}"
        except Exception as e:  # noqa: BLE001 - the probe reports what gloo said
            out[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return t.tolist()

    def all_gather():
        parts = [torch.empty(2, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
        return [p.tolist() for p in parts]

    def broadcast():
        t = torch.full((3,), float(rank), device=dev)
        dist.broadcast(t, 0)
        return t.tolist()

    def gather_object():
        names = [None, None]
        dist.all_gather_object(names, f"rank{rank}")
        return names

    attempt("all_reduce", all_reduce, [3.0] * 4)
    attempt("all_gather", all_gather, [[0.0, 0.0], [1.0, 1.0]])
    attempt("broadcast", broadcast, [0.0] * 3)
    attempt("all_gather_object", gather_object, ["rank0", "rank1"])
    mesh = make_mesh(device=dev)  # (2, 1): the data axis spans both ranks
    t = torch.full((4,), float(rank + 1), device=dev)
    attempt("mesh.all_reduce_", lambda: mesh.all_reduce_(t, "data").tolist(), [3.0] * 4)
    attempt("mesh.all_gather",
            lambda: mesh.all_gather(torch.full((2,), float(rank), device=dev), "data").tolist(),
            [0.0, 0.0, 1.0, 1.0])
    return out


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from playaid_core_torch.parallel.dryrun import spawn_ranks

    results = spawn_ranks(probe, 2, backend="gloo", timeout_s=120)
    for rank, res in enumerate(results):
        for name, what in res.items():
            print(f"rank {rank}: {name}: {what}")
    print(json.dumps({"torch": torch.__version__, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
