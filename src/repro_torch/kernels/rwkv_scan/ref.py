"""Plain-torch versions of the WKV6 kernel (mirrors
:mod:`repro.kernels.rwkv_scan.ref`: a loop over time) and of its gradient.

The CPU path runs them in place of the CUDA kernels, and ``chip_smoke.py``
holds the kernels against them on the card.  :func:`wkv6_bwd_blocked` is
for tests only: the backward kernel's order of work, transcribed.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u):
    """r/k/v/w: [B, H, T, N]; u: [H, N] -> o [B, H, T, N] (fp32)."""
    b, h, t, n = r.shape
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float()
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    out = torch.empty((b, h, t, n), dtype=torch.float32, device=r.device)
    for i in range(t):
        rt, kt, vt, wt = (x[:, :, i] for x in (r32, k32, v32, w32))
        kv = kt[..., :, None] * vt[..., None, :]           # [B, H, N, N]
        out[:, :, i] = ((s + u32[None, :, :, None] * kv)
                        * rt[..., :, None]).sum(-2)
        s = wt[..., :, None] * s + kv
    return out


def wkv6_bwd_ref(r, k, v, w, u, do):
    """The gradient of :func:`wkv6_ref` by autograd: (dr, dk, dv, dw, du)
    of ``<wkv6_ref(r, k, v, w, u), do>``, in f32 (the last step's w
    reaches no output: its gradient is zero)."""
    with torch.enable_grad():
        leaves = [x.detach().float().requires_grad_(True)
                  for x in (r, k, v, w, u)]
        out = wkv6_ref(*leaves)
        return torch.autograd.grad(out, leaves, do.float(),
                                   allow_unused=True, materialize_grads=True)


#: ``csrc/wkv6_bwd.cu``'s checkpoint interval (``kChunk``) and the steps
#: whose states a thread keeps in registers (``kSub``).
BWD_CHUNK_STEPS = 16
BWD_SUB_STEPS = 8


def _fma(a, b, c):
    """f32 fmaf: the product is exact in f64, then one rounding (and a
    second, to f32, that can differ from fmaf's only on a tie)."""
    return (a.double() * b.double() + c.double()).float()


def _dot4(a, b):
    """The kernel's sum over a thread's 4 columns (last dim, split as
    [..., lanes, 4]): a0 b0, then an fmaf a column."""
    a = a.unflatten(-1, (-1, 4))
    b = b.unflatten(-1, (-1, 4))
    acc = a[..., 0] * b[..., 0]
    for j in range(1, 4):
        acc = _fma(a[..., j], b[..., j], acc)
    return acc


def _high_first(x):
    """A shuffle sum over the last dim's lanes, the highest lane bit first
    (lane l with l + n/2, then with l + n/4, ...)."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _low_first(x):
    """A shuffle sum over the last dim's lanes, the lowest lane bit first."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def wkv6_bwd_blocked(r, k, v, w, u, do):
    """:func:`wkv6_bwd_ref`'s gradient in ``csrc/wkv6_bwd.cu``'s order of
    work (tests only; the kernel itself runs only on the card): checkpoints
    every :data:`BWD_CHUNK_STEPS` steps from a forward sweep; each chunk,
    from the last, recomputed from its checkpoint as two sub-chunks of
    :data:`BWD_SUB_STEPS` steps (the later first) and stepped backwards;
    u's terms folded into a_t = dO_t . v_t and c_t = sum r_t u k_t (each
    a sum over the prologue threads' slices); the row sums over a thread's
    4 columns, then over a row's lanes; dv over a thread's rows, the warp's
    row groups, the first warp adding dO_t c_t, then the warps in order;
    du over time backwards, then the batch in order.  Sums in f32 with the
    kernel's fmaf."""
    b, h, t_len, n = r.shape
    rt = 2 if n == 16 else 4                  # rows a thread
    lanes = n // 4                            # lanes a row group
    groups = 32 // lanes                      # row groups a warp
    threads = n // rt * lanes                 # one CTA a (b, h)
    warps, per = threads // 32, threads // BWD_CHUNK_STEPS
    n_ck = -(-t_len // BWD_CHUNK_STEPS)
    pad = n_ck * BWD_CHUNK_STEPS - t_len
    r, k, v, w, do = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                      for x in (r, k, v, w, do))
    u = u.float()

    def advance(s, t):
        kt, vt = k[:, :, t], v[:, :, t]
        return _fma(w[:, :, t, :, None], s, kt[..., :, None] * vt[..., None, :])

    # sweep 1
    ckpt = []
    s = r.new_zeros((b, h, n, n))
    for c in range(n_ck):
        ckpt.append(s)
        if c < n_ck - 1:
            for t in range(c * BWD_CHUNK_STEPS, (c + 1) * BWD_CHUNK_STEPS):
                s = advance(s, t)

    def prologue(t):
        """a_t and each rank's c_t, as the kernel's prologue threads sum."""
        a, c = (_low_first(_seq(x.unflatten(-1, (per, n // per)),
                                y.unflatten(-1, (per, n // per))))
                for x, y in ((do[:, :, t], v[:, :, t]),
                             (r[:, :, t] * u, k[:, :, t])))
        return a, c                        # [B, H] each

    grads = [torch.zeros((b, h, t_len, n)) for _ in range(4)]
    g = r.new_zeros((b, h, n, n))
    du = r.new_zeros((b, h, n))

    def step(sp, t):
        nonlocal g, du
        a, c = prologue(t)
        rt_, kt, wt, vt, dt = (x[:, :, t] for x in (r, k, w, v, do))
        dr = _high_first(_dot4(dt[:, :, None, :].expand_as(sp), sp))
        dk = _high_first(_dot4(g, vt[:, :, None, :].expand_as(g)))
        dw = _high_first(_dot4(g, sp))
        dr = _fma(u * kt, a[..., None], dr)
        dk = _fma(rt_ * u, a[..., None], dk)
        # dv: a thread's rows, then the warp's row groups (lowest bit first)
        gk = (g * kt[..., :, None]).unflatten(2, (warps, groups, rt))
        gg = g.unflatten(2, (warps, groups, rt))
        kk = kt.unflatten(2, (warps, groups, rt))
        y = gk[..., 0, :]
        for q in range(1, rt):
            y = _fma(gg[..., q, :], kk[..., q, None], y)
        y = _low_first(y.movedim(-2, -1))     # [B, H, warps, N]
        y[:, :, 0] = _fma(dt, c[..., None], y[:, :, 0])
        dv = y[:, :, 0]
        for wp in range(1, warps):
            dv = dv + y[:, :, wp]
        g = _fma(wt[..., :, None], g, rt_[..., :, None] * dt[..., None, :])
        du = _fma(rt_ * kt, a[..., None], du)
        if t < t_len:
            for out, x in zip(grads, (dr, dk, dv, dw)):
                out[:, :, t] = x

    nsub = BWD_CHUNK_STEPS // BWD_SUB_STEPS
    for c in reversed(range(n_ck)):
        t0 = c * BWD_CHUNK_STEPS
        firsts = [ckpt[c]]            # each sub-chunk's first state
        for q in range(1, nsub):
            s = firsts[-1]
            for t in range(t0 + (q - 1) * BWD_SUB_STEPS,
                           t0 + q * BWD_SUB_STEPS):
                s = advance(s, t)
            firsts.append(s)
        for q in reversed(range(nsub)):
            base = t0 + q * BWD_SUB_STEPS
            states = [firsts[q]]
            for t in range(base, base + BWD_SUB_STEPS - 1):
                states.append(advance(states[-1], t))
            for sub in reversed(range(BWD_SUB_STEPS)):
                step(states[sub], base + sub)
    du_sum = du[0].clone()
    for i in range(1, b):
        du_sum = du_sum + du[i]
    return (*grads, du_sum)


def _seq(a, b):
    """sum over the last dim of a * b as one thread's fmaf chain from 0."""
    acc = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        acc = _fma(a[..., j], b[..., j], acc)
    return acc
