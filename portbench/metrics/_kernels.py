"""Kernel-name classes shared by the readers."""
from __future__ import annotations

import re

#: the products' kernels: cuBLAS (nvjet, xmma, gemm) and CUTLASS
GEMM = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.I)
#: the port's own kernels, never counted as products
OWN = re.compile(r"\b(flash_wgmma_kernel|flash_fwd_kernel|fa_bwd_\w+|"
                 r"wkv6_kernel|wkv6_bwd_kernel|leaf_search_kernel)\b")


def named(ops, pattern: str) -> list:
    rx = re.compile(rf"\b{pattern}\b")
    return [o for o in ops if rx.search(o.name)]


def seconds(ops) -> float:
    return sum(o.end_ns - o.start_ns for o in ops) / 1e9
