#!/usr/bin/env python3
"""Which collectives and dtypes torch.distributed's gloo backend takes, on
CPU tensors and on CUDA tensors, with two ranks on this host's first card.

    PYTHONPATH=src python scripts/gloo_probe.py [--device cpu]

Each rank tries every collective in every dtype (a probe: a refusal is
the answer, so it is caught and printed), checks the result's values, and
prints one line a (collective, dtype): ``ok``, ``wrong`` or the error's
first line.  The last line is a JSON object of what ran and was right.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

DTYPES = ("float32", "bfloat16", "int32", "uint8")
OPS = ("all_reduce", "broadcast", "all_gather_into_tensor", "all_gather",
       "reduce_scatter_tensor", "all_to_all_single")


def _try(op: str, dtype, dev):
    import torch
    import torch.distributed as dist
    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), r + 1, dtype=dtype, device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        want = torch.full((4,), w * (w + 1) // 2, dtype=dtype, device=dev)
        return torch.equal(x, want)
    if op == "broadcast":
        dist.broadcast(x, 0)
        return torch.equal(x, torch.ones_like(x))
    if op == "all_gather_into_tensor":
        out = torch.empty((w * 4,), dtype=dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        return all(bool((out[i * 4:(i + 1) * 4] == i + 1).all())
                   for i in range(w))
    if op == "all_gather":
        outs = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(outs, x)
        return all(bool((o == i + 1).all()) for i, o in enumerate(outs))
    if op == "reduce_scatter_tensor":
        inp = torch.full((w * 4,), r + 1, dtype=dtype, device=dev)
        dist.reduce_scatter_tensor(x, inp)
        return bool((x == w * (w + 1) // 2).all())
    if op == "all_to_all_single":
        inp = torch.full((w * 4,), r + 1, dtype=dtype, device=dev)
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        return all(bool((out[i * 4:(i + 1) * 4] == i + 1).all())
                   for i in range(w))
    raise ValueError(op)


def probe_rank(mesh):
    import warnings
    import torch
    warnings.simplefilter("ignore", FutureWarning)
    out = {}
    for op in OPS:
        for name in DTYPES:
            try:
                ok = _try(op, getattr(torch, name), mesh.device)
                out[f"{op} {name}"] = "ok" if ok else "wrong"
            except Exception as e:          # the probe's answer
                out[f"{op} {name}"] = str(e).splitlines()[0][:120]
    return out


def main(argv=None) -> int:
    from repro_torch.launch.mesh import run_mesh
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import torch
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, device "
          f"{args.device or 'cuda'}", flush=True)
    res = run_mesh(probe_rank, 1, 2, backend="gloo", device=args.device,
                   timeout=300)
    for k, v in res[0].items():
        print(f"{k:36s} {v}")
    print(json.dumps(sorted(k for k, v in res[0].items()
                            if v == "ok" and res[1][k] == "ok")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
