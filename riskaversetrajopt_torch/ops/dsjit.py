"""Compensated (double-single) arithmetic for the float32 path.

The counterpart of ``riskaversetrajopt_tpu/ops/dsjit.py`` (its docstring
gives the reasoning). A float is a pair (hi, lo) with hi = fl(hi + lo); the
error-free transforms below recover the rounding error of a sum or a product
exactly:

- operands are split by mantissa bit-masking (``Tensor.view`` as an integer
  type, bitwise AND), which is exact by construction; binary32 keeps 12
  significant bits, so every partial product of split operands has at most
  24 bits and is exact in float32;
- `two_sum` uses adds and subtracts only.

PyTorch runs these ops eagerly, one kernel per op, so every intermediate is
rounded to the working type as written: nothing is fused into an FMA and
nothing is simplified algebraically. That is what the transforms rely on,
and what JAX needs ``optimization_barrier`` for. So these functions must not
be put under ``torch.compile``, whose code generation may contract a
multiply and an add into an FMA or fold ``(a + b) - a`` into ``b``; and no
fused op (``addcmul``, ``addmm`` and the like) may stand inside an
error-free transform.

All functions take float32 or float64 (float64 gives the double-double
split with one rounded low-order product).
"""

from __future__ import annotations

import torch

# mask away the low mantissa bits: binary32 keeps 12 significant bits (11
# stored), binary64 keeps 27 (Dekker's split point); dsjit.py:40-43
_MASKS = {
    torch.float32: (torch.int32, 0xFFFFF000 - 0x100000000),
    torch.float64: (torch.int64, -0x4000000),  # 0xFFFFFFFFFC000000
}


def mask_split(a):
    """Exact a = hi + lo with a truncated-mantissa hi."""
    ity, mask = _MASKS[a.dtype]
    hi = torch.bitwise_and(a.view(ity), mask).view(a.dtype)
    return hi, a - hi  # a - hi is exact: lo is a's truncated tail


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; adds only)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b| (renormalization)."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """a * b = p + e; all partial products exact via mask_split."""
    p = a * b
    kw = dict(dtype=p.dtype, device=p.device)
    a1, a2 = mask_split(torch.as_tensor(a, **kw))
    b1, b2 = mask_split(torch.as_tensor(b, **kw))
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def ds_add(h1, l1, h2, l2):
    """(h1, l1) + (h2, l2), renormalized."""
    s, e = two_sum(h1, h2)
    return quick_two_sum(s, e + l1 + l2)


def ds_neg(h, l):
    return -h, -l


def ds_scale(h, l, s):
    """(h, l) * s for an exact scalar/array s."""
    p, e = two_prod(h, s)
    return quick_two_sum(p, e + l * s)


def ds_mul(h1, l1, h2, l2):
    """(h1, l1) * (h2, l2) to first order in the low parts."""
    p, e = two_prod(h1, h2)
    return quick_two_sum(p, e + h1 * l2 + l1 * h2)


def ds_div(h, l, d):
    """(h, l) / d for an exact divisor d: one Newton correction of the
    quotient, the residual formed exactly via two_prod."""
    q0 = h / d
    p, e = two_prod(q0, d)
    r = ((h - p) - e) + l
    return quick_two_sum(q0, r / d)


def ds_round(h, l):
    """Best single-float representation of (h, l)."""
    return h + l


def ds_where(c, h1, l1, h2, l2):
    return torch.where(c, h1, h2), torch.where(c, l1, l2)


def _pad_pow2(h, l, axis):
    n = h.shape[axis]
    p = 1
    while p < n:
        p *= 2
    if p == n:
        return h, l
    shape = list(h.shape)
    shape[axis] = p - n
    z = h.new_zeros(shape)
    return torch.cat([h, z], dim=axis), torch.cat([l, z], dim=axis)


def ds_sum(h, l, axis):
    """Compensated reduction of (hi, lo) pairs along `axis` (an int or a
    tuple of ints) by pairwise halving with ds_add: ~log2(n)
    renormalization roundings (eps^2-class)."""
    if isinstance(axis, (tuple, list)):
        for ax in sorted(axis, reverse=True):
            h, l = ds_sum(h, l, ax)
        return h, l
    h, l = _pad_pow2(h, l, axis)
    while h.shape[axis] > 1:
        half = h.shape[axis] // 2
        h, l = ds_add(h.narrow(axis, 0, half), l.narrow(axis, 0, half),
                      h.narrow(axis, half, half), l.narrow(axis, half, half))
    return h.squeeze(axis), l.squeeze(axis)


def sum1_ds(x, axis=None):
    """Compensated sum of a plain array."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return ds_sum(x, torch.zeros_like(x), axis)


def dot2(A, x):
    """Compensated A @ x for a dense (m, n) A (Ogita-Rump-Oishi Dot2
    accuracy): exact elementwise products, pairwise ds reduction. Returns
    an (m,) ds pair."""
    p, e = two_prod(A, x[None, :])
    return ds_sum(p, e, axis=1)


def rdot2(A, w):
    """Compensated A.T @ w for dense (m, n) A and (m,) w."""
    p, e = two_prod(A, w[:, None])
    return ds_sum(p, e, axis=0)


def contract_mkn_n(G, x_h, x_l, chunk=None):
    """Compensated einsum('mkn,n->mk', G, x) with a ds vector x.

    `chunk` bounds the working set by walking the sample axis in slices of
    that size; the reduction is over the minor axis only, so the result does
    not depend on it."""
    def part(g):
        p, e = two_prod(g, x_h[None, None, :])
        e = e + g * x_l[None, None, :]
        return ds_sum(p, e, axis=2)

    if chunk is None or G.shape[0] <= chunk:
        return part(G)
    parts = [part(g) for g in torch.split(G, chunk, dim=0)]
    return (torch.cat([h for h, _ in parts]), torch.cat([lo for _, lo in parts]))


def contract_mkn_mk(G, w_h, w_l, chunk=None):
    """Compensated einsum('mkn,mk->n', G, w) with ds weights w.

    With `chunk`, the per-slice (n,) partials are ds-accumulated across
    slices (one extra eps^2 rounding per slice)."""
    def part(g, wh, wl):
        p, e = two_prod(g, wh[:, :, None])
        e = e + g * wl[:, :, None]
        return ds_sum(p, e, axis=(0, 1))

    if chunk is None or G.shape[0] <= chunk:
        return part(G, w_h, w_l)
    h = lo = G.new_zeros(G.shape[2])
    for g, wh, wl in zip(torch.split(G, chunk), torch.split(w_h, chunk),
                         torch.split(w_l, chunk)):
        h, lo = ds_add(h, lo, *part(g, wh, wl))
    return h, lo
