"""Double-double arithmetic on float64 tensors: a real is an unevaluated
sum hi + lo of two doubles (|lo| <= ulp(hi) / 2, about 106 bits), here a
pair ``(hi, lo)`` of tensors that broadcast together; a complex number is
a pair ``(re, im)`` of such reals.

The operations are those of ``csrc/leaver_cf.cu``'s double-double variant,
in the same order: two-sum written out, and two-prod by Dekker's split,
which is exact like the kernel's fused multiply-add (so both give the same
error term), then the same renormalisations.  Each torch operation rounds
on its own (nothing is contracted).  Used by ``cf_cuda.cf_dd``, the plain
version of that kernel variant.
"""

from __future__ import annotations

import torch

__all__ = ["add", "add_d", "div", "mul", "mul_d", "neg", "of", "rounded",
           "scaled", "sqrt", "sub", "two_prod", "two_sum", "zabs", "zadd",
           "zadd_d", "zdiv", "zdiv_r", "zmul", "zmul_d", "zmul_r",
           "zneg", "zof", "zscaled", "zsqrt", "zsub", "ztimes_i"]

# Dekker's splitter for doubles: 2^27 + 1.
_SPLIT = 134217729.0


def two_sum(a, b):
    """a + b exactly, as (s, e)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """a + b exactly where |a| >= |b| (or a = 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """a b exactly, as (p, e): Dekker's product (no overflow at these
    magnitudes, |a|, |b| < 2^996)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def of(x):
    """A double (a float or a float64 tensor) as a double-double."""
    return x, (torch.zeros_like(x) if torch.is_tensor(x) else 0.0)


def neg(x):
    return -x[0], -x[1]


def add(x, y):
    s, se = two_sum(x[0], y[0])
    t, te = two_sum(x[1], y[1])
    s, se = _fast_two_sum(s, se + t)
    return _fast_two_sum(s, se + te)


def add_d(x, y):
    """x + y for y a double."""
    s, se = two_sum(x[0], y)
    return _fast_two_sum(s, se + x[1])


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    p, e = two_prod(x[0], y[0])
    return _fast_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def mul_d(x, y):
    """x y for y a double."""
    p, e = two_prod(x[0], y)
    return _fast_two_sum(p, e + x[1] * y)


def div(x, y):
    q1 = x[0] / y[0]
    r1 = sub(x, mul_d(y, q1))
    q2 = r1[0] / y[0]
    r2 = sub(r1, mul_d(y, q2))
    return add_d(_fast_two_sum(q1, q2), r2[0] / y[0])


def sqrt(x):
    """One Newton step from the FP64 root, s + (x - s^2) / (2 s); 0 where
    x <= 0."""
    pos = x[0] > 0.0
    xh = torch.where(pos, x[0], 1.0)
    s = torch.sqrt(xh)
    p, e = two_prod(s, s)
    hi, lo = _fast_two_sum(s, ((xh - p) - e + x[1]) / (2.0 * s))
    zero = torch.zeros((), dtype=hi.dtype, device=hi.device)
    return torch.where(pos, hi, zero), torch.where(pos, lo, zero)


def scaled(x, f):
    """x f for f a power of two (a float or a tensor): exact."""
    return x[0] * f, x[1] * f


def rounded(x):
    """The double nearest x."""
    return x[0] + x[1]


# Complex double-doubles: (re, im), each a double-double.

def zof(z):
    """A complex128 tensor as a complex double-double."""
    return of(z.real), of(z.imag)


def zneg(x):
    return neg(x[0]), neg(x[1])


def zadd(x, y):
    return add(x[0], y[0]), add(x[1], y[1])


def zsub(x, y):
    return sub(x[0], y[0]), sub(x[1], y[1])


def zadd_d(x, y):
    """x + y for y a real double."""
    return add_d(x[0], y), x[1]


def zmul(x, y):
    return (sub(mul(x[0], y[0]), mul(x[1], y[1])),
            add(mul(x[0], y[1]), mul(x[1], y[0])))


def zmul_r(x, y):
    """x y for y a real double-double."""
    return mul(x[0], y), mul(x[1], y)


def zmul_d(x, y):
    """x y for y a real double."""
    return mul_d(x[0], y), mul_d(x[1], y)


def zdiv(x, y):
    den = add(mul(y[0], y[0]), mul(y[1], y[1]))
    return (div(add(mul(x[0], y[0]), mul(x[1], y[1])), den),
            div(sub(mul(x[1], y[0]), mul(x[0], y[1])), den))


def zdiv_r(x, y):
    """x / y for y a real double-double."""
    return div(x[0], y), div(x[1], y)


def ztimes_i(x):
    """i x, exact."""
    return neg(x[1]), x[0]


def zscaled(x, f):
    return scaled(x[0], f), scaled(x[1], f)


def zabs(x):
    return sqrt(add(mul(x[0], x[0]), mul(x[1], x[1])))


def zsqrt(z):
    """Principal square root (branch cut on the negative real axis)."""
    re, im = z
    neg_re = re[0] < 0.0
    t = sqrt(scaled(add(sqrt(add(mul(re, re), mul(im, im))),
                        tuple(torch.where(neg_re, -p, p) for p in re)), 0.5))
    half_im = div(scaled(im, 0.5), t)
    neg_im = im[0] < 0.0
    abs_half_im = tuple(torch.where(neg_im, -p, p) for p in half_im)
    signed_t = tuple(torch.where(neg_im, -p, p) for p in t)
    out_re = tuple(torch.where(neg_re, p, q) for p, q in zip(abs_half_im, t))
    out_im = tuple(torch.where(neg_re, p, q) for p, q in zip(signed_t,
                                                             half_im))
    zero = (re[0] == 0.0) & (im[0] == 0.0)
    return (tuple(torch.where(zero, torch.zeros_like(p), p) for p in out_re),
            tuple(torch.where(zero, q, p) for p, q in zip(out_im, im)))
