"""Tiny versions of the benchmark's cells for tests on the CPU: every
width cut, float32, a short batch; the same files otherwise."""
from __future__ import annotations

import copy

from portbench import harness

TINY_MODEL = {
    "rwkv6-1.6b": dict(n_layers=2, d_model=64, head_size=16, d_ff=128,
                       vocab=512, wkv={"layers": 2, "heads": 4,
                                       "head_size": 16}),
    "internvl2-1b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab=512,
                         prefix={"key": "patches", "length": 8},
                         attention={"layers": 2, "heads": 4, "kv_heads": 2,
                                    "head_dim": 16, "causal": True}),
}
TINY_PROGRAM = {
    "rwkv6-1.6b": dict(n_layers=2, d_model=64, d_ff=128, vocab=512,
                       rwkv_head_dim=16),
    "internvl2-1b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=512, n_patches=8),
}
TINY_TRAFFIC = dict(batch=2, seq=16, ring=4)


def tiny_cell(name: str, dtype: str = "float32") -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    key = cfg["name"]
    cfg["model"].update(copy.deepcopy(TINY_MODEL[key]))
    cfg["dtype"] = dtype
    cfg["program"]["overrides"] = dict(cfg["program"]["overrides"],
                                       dtype=dtype, **TINY_PROGRAM[key])
    cfg["program"]["agrees"] = {}
    traffic = dict(copy.deepcopy(cell.traffic), **TINY_TRAFFIC)
    return harness.Cell(name=cell.name, entry=cell.entry, config=cfg,
                        traffic=traffic, limits=dict(cell.limits))
