"""The port's compensated arithmetic (ops/dsjit.py) against the JAX package's
(ops/dsjit.py) on the same float32 inputs, made with numpy from a seed: the
error-free transforms bit for bit, and the compensated reductions to 1e-12
of the float64 truth, as tests/test_dsjit.py holds the JAX functions."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riskaversetrajopt_torch.ops import dsjit as tds
from riskaversetrajopt_tpu.ops import dsjit as jds


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f64(*parts):
    return sum(np.asarray(p, np.float64) for p in parts)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mask_split_matches_jax_bitwise(dtype):
    x = (1e3 * np.random.default_rng(0).standard_normal(1024)).astype(dtype)
    hi, lo = tds.mask_split(_t(x))
    hi_j, lo_j = jax.jit(jds.mask_split)(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(_f64(hi.numpy(), lo.numpy()), _f64(x))


def test_two_sum_and_two_prod_match_jax_bitwise():
    a, b = _rand(1, 4096), _rand(2, 4096, scale=1e-5)
    for fn in ("two_sum", "two_prod"):
        got = getattr(tds, fn)(_t(a), _t(b))
        ref = jax.jit(getattr(jds, fn))(jnp.asarray(a), jnp.asarray(b))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=fn)
    # both transforms are exact: the float64 value of the pair is the truth
    s, e = tds.two_sum(_t(a), _t(b))
    np.testing.assert_array_equal(_f64(s.numpy(), e.numpy()), _f64(a) + _f64(b))
    p, e = tds.two_prod(_t(37 * a), _t(b))
    np.testing.assert_array_equal(_f64(p.numpy(), e.numpy()),
                                  _f64(37 * a) * _f64(b))


def test_ds_sum_compensated():
    """The ill-conditioned sum of test_dsjit.py:56-67."""
    x = np.concatenate([[1e8], np.full(4096, 0.1, np.float32), [-1e8]]
                       ).astype(np.float32)
    h, lo = tds.sum1_ds(_t(x))
    exact = np.sum(_f64(x))
    got = float(_f64(h.numpy(), lo.numpy()))
    assert abs(got - exact) / abs(exact) < 1e-6
    assert abs(float(torch.sum(_t(x))) - exact) > 100 * abs(got - exact)


def test_dot2_rdot2_vs_f64():
    A, x, w = _rand(3, (64, 200), 5.0), _rand(4, 200, 2.0), _rand(5, 64, 0.7)
    for (h, lo), exact in ((tds.dot2(_t(A), _t(x)), _f64(A) @ _f64(x)),
                           (tds.rdot2(_t(A), _t(w)), _f64(A).T @ _f64(w))):
        err = np.max(np.abs(_f64(h.numpy(), lo.numpy()) - exact))
        assert err / np.max(np.abs(exact)) < 1e-12, err


@pytest.mark.parametrize("chunk", [None, 8])
def test_contractions_vs_f64(chunk):
    """contract_mkn_n / contract_mkn_mk whole and in sample slices of 8 (a
    count that does not divide M=37)."""
    M, K, n = 37, 11, 23
    G, x, w = _rand(6, (M, K, n), 3.0), _rand(7, n, 1.5), _rand(8, (M, K), 0.7)
    h, lo = tds.contract_mkn_n(_t(G), _t(x), torch.zeros(n), chunk=chunk)
    exact = np.einsum("mkn,n->mk", _f64(G), _f64(x))
    got = _f64(h.numpy(), lo.numpy())
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 1e-12
    h, lo = tds.contract_mkn_mk(_t(G), _t(w), torch.zeros(M, K), chunk=chunk)
    exact = np.einsum("mkn,mk->n", _f64(G), _f64(w))
    got = _f64(h.numpy(), lo.numpy())
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 1e-12


def test_ds_ops_match_jax():
    """ds_add, ds_scale, ds_mul, ds_div and ds_sum against the JAX functions
    on the same pairs: the same operations in the same order, so equal."""
    h1, l1 = (_t(v) for v in tds.two_prod(_t(_rand(9, 512, 11.0)),
                                          _t(_rand(10, 512, 0.3))))
    h2, l2 = (_t(v) for v in tds.two_sum(_t(_rand(11, 512)),
                                         _t(_rand(12, 512, 1e-6))))
    s = _t(_rand(13, 512, 0.03))
    J = lambda *a: [jnp.asarray(v.numpy()) for v in a]  # noqa: E731
    pairs = [
        (tds.ds_add(h1, l1, h2, l2), jds.ds_add(*J(h1, l1, h2, l2))),
        (tds.ds_scale(h1, l1, s), jds.ds_scale(*J(h1, l1, s))),
        (tds.ds_mul(h1, l1, h2, l2), jds.ds_mul(*J(h1, l1, h2, l2))),
        (tds.ds_div(h1, l1, s), jds.ds_div(*J(h1, l1, s))),
        (tds.ds_sum(h1, l1, 0), jds.ds_sum(*J(h1, l1), 0)),
    ]
    for got, ref in pairs:
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # ds_scale by a float32 is exact
    h, lo = tds.ds_scale(h2, torch.zeros_like(h2), s)
    np.testing.assert_array_equal(_f64(h.numpy(), lo.numpy()),
                                  _f64(h2.numpy()) * _f64(s.numpy()))


def test_f64_path():
    """float64 gives double-double accuracy (math.fsum is exact)."""
    x = np.random.default_rng(6).standard_normal(2048) * 1e6
    h, lo = tds.sum1_ds(_t(x))
    exact = math.fsum(x.tolist())
    assert abs((float(h) + float(lo)) - exact) <= 1e-9 * abs(exact) + 1e-12
