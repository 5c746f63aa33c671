"""The one generator of the benchmark's traffic: a ring of training
batches drawn from a traffic file's parameters and the run's seed.

A traffic file (``traffic/<name>.json``) gives ``batch`` rows of ``seq``
text tokens, the token law (``zipf`` with its exponent ``alpha``) and
``ring`` distinct batches that the steps take in turn.  A configuration
with a ``prefix`` (a stubbed vision tower's patch embeddings) gets that
many float32 normal rows of its width in front of every row's text.

Tokens follow the inverse CDF of ``data/tokens.py::zipf_tokens`` in the
program, frozen here: a continuous power law of exponent ``alpha`` over
ranks 1 to V + 1, floored to a token id (that function names its
``alpha`` but draws with exponent 1).  All draws are made on the device
in a few calls, from a generator seeded by the run's seed.
"""
from __future__ import annotations

import torch

from portbench.seeds import sub_seed


def zipf_tokens(u: torch.Tensor, vocab: int, alpha: float) -> torch.Tensor:
    """Token ids in [0, vocab) from uniforms ``u`` in [0, 1) (float64):
    x on [1, V + 1) with density proportional to x^-alpha (alpha != 1),
    id floor(x) - 1."""
    a = 1.0 - alpha
    x = (1.0 + u * (float(vocab + 1) ** a - 1.0)) ** (1.0 / a)
    return torch.clamp(torch.floor(x) - 1, 0, vocab - 1).to(torch.int32)


def make_ring(traffic: dict, model: dict, seed: int, device) -> list:
    """``traffic["ring"]`` batches, each ``{"tokens": int32 [B, S]}`` and,
    with a prefix, ``{key: float32 [B, P, D]}``."""
    n, b, s = traffic["ring"], traffic["batch"], traffic["seq"]
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "traffic"))
    law = traffic["tokens"]
    if law["kind"] != "zipf":
        raise ValueError(f"unknown token law {law['kind']!r}")
    u = torch.rand(n * b * s, generator=gen, dtype=torch.float64,
                   device=device)
    tokens = zipf_tokens(u, model["vocab"], law["alpha"]).view(n, b, s)
    ring = [{"tokens": tokens[i].clone()} for i in range(n)]
    prefix = model.get("prefix")
    if prefix:
        emb = torch.randn((n, b, prefix["length"], model["d_model"]),
                          generator=gen, dtype=torch.float32, device=device)
        for i in range(n):
            ring[i][prefix["key"]] = emb[i].clone()
    return ring


def loss_positions(traffic: dict) -> int:
    """Text tokens a step's loss covers: each row's tokens but the first."""
    return traffic["batch"] * (traffic["seq"] - 1)
