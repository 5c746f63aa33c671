#!/usr/bin/env python3
"""Time the grouped expert product (``kernels/moe_gmm``) on the card at
the ``train-qwen1.5-moe-a2.7b`` cell's shape, and read the routing
counters of the cell's own training steps.

The shape is one layer of the cell: 16,384 tokens × top-4 = 65,536 sorted
(token, choice) rows, of which the 15 held experts take 16,384 on average
(1,092 or 1,093 each here, the rest past the groups), D 2,048, F 1,408.
For each product of the expert block (gate/up D → F and down F → D;
forward, the rows' gradient and the weights' gradient) it prints one JSON
line: the kernel's device time a call (CUDA events over repeated
launches) beside its bound (``portbench/flops_moe.py``: the larger of
2·P·D·F FLOPs at 989 TFLOP/s and the operands read once and the result
written once at 3.35 TB/s) and the share, and beside two ways the port
does not take: a loop of one cuBLAS product an expert over the same
groups (``torch.mm``, with the groups' sizes on the host), and
``torch.bmm`` over the 15 experts at the reference's capacity (factor
1.25: 1,365 rows an expert).

With ``--counters`` it then builds the cell's program as the benchmark
does (``portbench/harness.py``: weights and batches from ``--seed``),
runs the traffic's checked steps with the program's counting on and
prints each layer's counters (``models/moe.py::read_counters``): the pairs kept on the held experts
against the expected 16,384, the largest expert's, the pairs dropped.

    python3 scripts/moe_gmm_timing.py [--counters --seed N]

From the root of a checkout, on a machine with a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import flops_moe  # noqa: E402
from repro_torch.kernels.moe_gmm.kernel import gmm, gmm_dw  # noqa: E402

TOKENS, TOP_K, EXPERTS, HELD, D, F = 16384, 4, 60, 15, 2048, 1408
CAPACITY = int(1.25 * TOKENS * TOP_K / EXPERTS)


def device_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings() -> list:
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    m = TOKENS * TOP_K
    pairs = TOKENS * TOP_K * HELD // EXPERTS
    counts = [pairs // HELD + (i < pairs % HELD) for i in range(HELD)]
    ends = torch.tensor(counts, device="cuda").cumsum(0).to(torch.int32)
    bounds = [(s, s + c) for s, c in zip([0] + ends.tolist()[:-1], counts)]
    call = flops_moe.gmm_call(pairs, D, F, HELD)
    bound_ms = flops_moe.gmm_bound_s(call) * 1e3
    out = []
    for name, k, n in (("gate_up", D, F), ("down", F, D)):
        a = torch.randn(m, k, generator=g, device="cuda").to(bf)
        w = (torch.randn(HELD, k, n, generator=g, device="cuda")
             / k ** 0.5).to(bf)
        dy = torch.randn(m, n, generator=g, device="cuda").to(bf)
        wt = w.transpose(1, 2)
        ae, we = a[:pairs], w

        def loop(x, ws):
            return [x[s:e] @ ws[i] for i, (s, e) in enumerate(bounds)]
        xc = a[:HELD * CAPACITY].view(HELD, CAPACITY, k)
        dyc = dy[:HELD * CAPACITY].view(HELD, CAPACITY, n)
        kinds = {
            "forward": (lambda: gmm(a, w, ends),
                        lambda: loop(ae, we),
                        lambda: torch.bmm(xc, w)),
            "rows_grad": (lambda: gmm(dy, wt, ends),
                          lambda: loop(dy[:pairs], wt),
                          lambda: torch.bmm(dyc, wt)),
            "weights_grad": (lambda: gmm_dw(a, dy, ends),
                             lambda: [a[s:e].T @ dy[s:e] for s, e in bounds],
                             lambda: torch.bmm(xc.transpose(1, 2), dyc)),
        }
        for kind, (kernel, per_expert, at_capacity) in kinds.items():
            ms = device_ms(kernel)
            out.append(dict(
                product=f"{name}.{kind}", rows=m, pairs=pairs, groups=HELD,
                k=k, n=n, kernel_ms=ms, bound_ms=bound_ms,
                roofline_pct=100.0 * bound_ms / ms,
                bound_by="operations" if call["flops"] / 989e12
                > call["bytes"] / 3.35e12 else "bytes",
                cublas_per_expert_ms=device_ms(per_expert),
                bmm_at_capacity_ms=device_ms(at_capacity),
                capacity=CAPACITY, card=torch.cuda.get_device_name(0)))
        del a, w, dy, xc, dyc
    return out


def counters(seed: int) -> dict:
    from portbench import harness
    from portbench.traffic import make_ring
    from repro_torch.models import moe as M
    cell = harness.load_cell("train-qwen1.5-moe-a2.7b")
    ring = make_ring(cell.traffic, cell.model, seed, "cuda")
    prog = harness.Program(cell, seed, "cuda")
    with M.counting():
        for _ in range(cell.traffic["checked_steps"]):
            prog.step(ring)
    layers = M.read_counters([lp.moe for lp in prog.model.layers])
    expected = flops_moe.expected_pairs(
        cell.model, cell.traffic["batch"] * cell.traffic["seq"])
    return dict(seed=seed, expected_kept=expected, layers=layers,
                mean_kept=sum(c["sums"]["kept"] / c["calls"] for c in layers)
                / len(layers),
                max_largest=max(c["sums"]["largest"] / c["calls"]
                                for c in layers),
                dropped=sum(c["sums"]["dropped"] for c in layers))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--counters", action="store_true")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    args = ap.parse_args()
    for row in timings():
        print(json.dumps(row), flush=True)
    if args.counters:
        torch.cuda.empty_cache()
        print(json.dumps(counters(args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
