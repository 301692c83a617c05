"""Catmull-Rom splines and Fourier series: interpolation and sampling.

Port of pbrt_tpu/core/interpolation.py (interpolation.{h,cpp}:40-460), used
by the Fourier BSDF (materials/fourier.py) and the tabulated BSSRDF
(materials/bssrdf.py).  pbrt's scalar Newton-bisection loops run a fixed 40
steps over the lane axis, with each lane frozen once it converges, as in the
JAX package; FindInterval on a per-lane interpolated CDF is a log2-depth
bisection.

A Fourier series runs the JAX package's double-angle recurrence for
cos(k phi) (and sin(k phi)) order by order, each step rounded to float32
as XLA:CPU's fused multiply-add rounds it, and sums its terms in order in
float32: one operation an order for the recurrence and one for the sum,
whole-tensor operations over the lanes.  Its float32 rounding grows with
the order, so a direct cos(k phi) or a tree sum lands outside the
function bars on the in-repo table (a g channel that cancels, peaks of
172 orders); with the recurrence and the ordered sum fourier_eval is bit
for bit the JAX package's on the CPU.  The series is one autograd function
(_RecurrenceSeries): its forward is that recurrence and sum, and its
backward recomputes the table and runs the recurrence's adjoint, so a
grad step differentiates it, sample_fourier's 40 Newton steps included,
with the forward's bits unchanged and no table held for the backward.

The host (numpy) helpers build the BSSRDF tables and invert reflectance
curves (IntegrateCatmullRom / InvertCatmullRom, interpolation.cpp:255-345).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .vecmath import safe_sqrt

_NEWTON_ITERS = 40  # bisection halves [a, b]: 2^-40, well below pbrt's 1e-6


def catmull_rom_weights(nodes, x):
    """nodes [n] (sorted), x [...] -> (offset, weights [..., 4], valid):
    offset is the index of the first of the 4 control points; x out of
    [nodes[0], nodes[-1]] gives valid False, finite weights
    (interpolation.cpp:61-103)."""
    n = nodes.shape[0]
    valid = (x >= nodes[0]) & (x <= nodes[n - 1])
    idx = torch.clamp(torch.searchsorted(nodes, x.contiguous(), right=True) - 1,
                      0, n - 2)
    x0 = nodes[idx]
    x1 = nodes[idx + 1]
    t = (x - x0) / torch.where(x1 == x0, 1.0, x1 - x0)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    has_prev = idx > 0
    xm1 = nodes[torch.clamp(idx - 1, min=0)]
    w0p = (t3 - 2 * t2 + t) * (x1 - x0) / torch.where(has_prev, x1 - xm1, 1.0)
    w0n = t3 - 2 * t2 + t  # no previous node: folded into w1 and w2
    w0 = torch.where(has_prev, -w0p, 0.0)
    w1 = torch.where(has_prev, w1, w1 - w0n)
    w2 = w2 + torch.where(has_prev, w0p, w0n)
    has_next = idx + 2 < n
    xp2 = nodes[torch.clamp(idx + 2, max=n - 1)]
    w3p = (t3 - t2) * (x1 - x0) / torch.where(has_next, xp2 - x0, 1.0)
    w3n = t3 - t2
    w3 = torch.where(has_next, w3p, 0.0)
    w1 = w1 - torch.where(has_next, w3p, w3n)
    w2 = w2 + torch.where(has_next, 0.0, w3n)
    return idx - 1, torch.stack([w0, w1, w2, w3], -1), valid


def _chebyshev(c, prev, cur, m_max: int):
    """[m_max, ...] f32, order-major: the double-angle
    recurrence x_{k+1} = 2 c x_k - x_{k-1} from (x_{-1}, x_0) = (prev,
    cur), each step rounded to float32 once, as the fused multiply-add
    XLA:CPU makes of the JAX package's (2 c x_k is exact in float64).  The
    table holds y_k = s_k x_k with s_k = +1, +1, -1, -1, ... so that each
    step is one addcmul, y_{k+1} = y_{k-1} + (s_{k+1} s_k 2c) y_k; rounding
    is symmetric, so |y_k| = |x_k| bit for bit, and callers fold s_k
    (_chebyshev_signs) into their coefficients.  One operation an order."""
    two = (2.0 * c).to(torch.float64)
    steps = (two, -two)  # s_{k+1} s_k: +1 at even k, -1 at odd
    tab = torch.empty((m_max,) + cur.shape, dtype=torch.float32, device=c.device)
    rows = tab.unbind(0)
    rows[0].copy_(cur)
    if m_max > 1:  # y_1 = x_1 = 2 c x_0 - x_{-1}
        torch.addcmul(-prev.to(torch.float64), two, rows[0], out=rows[1])
    for k in range(1, m_max - 1):
        torch.addcmul(rows[k - 1], steps[k % 2], rows[k], out=rows[k + 1])
    return tab


def _chebyshev_signs(m_max: int, device):
    """s_k of _chebyshev's table: +1, +1, -1, -1, ..."""
    return torch.tensor([1.0, 1.0, -1.0, -1.0], device=device).repeat(
        (m_max + 3) // 4)[:m_max]


def _series(terms):
    """The sum over the first (order) axis, term by term in float32, in
    order, as the JAX package's loops add them."""
    rows = terms.unbind(0)
    val = rows[0].clone()
    for row in rows[1:]:
        val.add_(row)
    return val


def _live(m, m_max: int, device):
    """[m_max, ...] mask k < m."""
    ks = torch.arange(m_max, device=device)
    return ks.view((m_max,) + (1,) * m.dim()) < m


class _RecurrenceSeries(torch.autograd.Function):
    """sum_k coef_k y_k over _chebyshev's table y of (c, prev, cur), with
    the terms masked by live and term 0 replaced by head when given.  The
    forward is the float32 recurrence and ordered sum above, bit for bit;
    the backward recomputes the table and runs the recurrence's adjoint
    (a_k = g_k + t_k a_{k+1} + a_{k+2}, t_k the step's factor 2c or -2c),
    so the table is not held for the backward pass."""

    @staticmethod
    def forward(ctx, c, prev, cur, coef, live, head):
        tab = _chebyshev(c, prev, cur, coef.shape[0])
        terms = coef * tab
        if live is not None:
            terms = torch.where(live, terms, 0.0)
        if head is not None:
            terms[0] = head
        ctx.save_for_backward(c, prev, cur, coef, live, head)
        return _series(terms)

    @staticmethod
    def backward(ctx, g):
        c, prev, cur, coef, live, head = ctx.saved_tensors
        m_max = coef.shape[0]
        tab = _chebyshev(c, prev, cur, m_max)
        g_terms = g.expand((m_max,) + g.shape)
        if live is not None:
            g_terms = torch.where(live, g_terms, 0.0)
        if head is not None:
            g_terms = torch.cat([torch.zeros_like(g_terms[:1]), g_terms[1:]])
        g_coef = (g_terms * tab).sum_to_size(coef.shape)
        g_tab = (g_terms * coef).sum_to_size(tab.shape)
        # the adjoint of each row, last order first
        two = 2.0 * c
        steps = (two, -two)  # t_k: 2c at even k (y_1's too), -2c at odd
        g_rows = g_tab.unbind(0)
        adj = [None] * m_max
        adj[m_max - 1] = g_rows[m_max - 1]
        for k in range(m_max - 2, -1, -1):
            rest = g_rows[k] if k + 2 >= m_max else g_rows[k] + adj[k + 2]
            adj[k] = torch.addcmul(rest, steps[k % 2], adj[k + 1])
        g_c = torch.zeros_like(tab[0])
        if m_max > 1:  # d t_k / d c = 2 at even k, -2 at odd
            sign = torch.tensor([2.0, -2.0], device=c.device).repeat(
                m_max // 2 + 1)[:m_max - 1].view((-1,) + (1,) * tab[0].dim())
            g_c = torch.sum(sign * torch.stack(adj[1:]) * tab[:-1], 0)
        g_prev = -adj[1] if m_max > 1 else torch.zeros_like(adj[0])
        return (g_c.sum_to_size(c.shape), g_prev.sum_to_size(prev.shape),
                adj[0].sum_to_size(cur.shape), g_coef, None,
                None if head is None else g)


def fourier_eval(ak, cos_phi, m=None):
    """sum_k ak[..., k] cos(k phi) over k < m (interpolation.cpp:348-361).
    ak [..., m_max]; cos_phi and m (or None, all orders) broadcast against
    ak.shape[:-1]."""
    m_max = ak.shape[-1]
    coef = (ak * _chebyshev_signs(m_max, ak.device)).movedim(-1, 0)
    live = None if m is None else _live(m, m_max, ak.device)
    return _RecurrenceSeries.apply(cos_phi, cos_phi, torch.ones_like(cos_phi),
                                   coef, live, None)


def sample_fourier(ak, u, m=None):
    """Importance-sample phi from a Fourier series (interpolation.cpp:
    363-421).  ak [n, m_max] (luminance coefficients), u [n] in [0, 1).
    Returns (f value, pdf, phi).  Newton-bisection runs _NEWTON_ITERS
    steps; a lane that converges is frozen."""
    m_max = ak.shape[-1]
    dev = ak.device
    flip = u >= 0.5
    u = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    a0 = ak[:, 0]
    ks = torch.arange(m_max, device=dev)
    # [m_max, n, 2]: the integral's coefficients a_k / k beside the
    # series' a_k, orders k >= 1 below m
    coef = torch.stack([ak / torch.clamp(ks, min=1).to(torch.float32), ak], -1)
    live = (ks >= 1)[:, None]
    if m is not None:
        live = live & _live(m, m_max, dev)
    coef = torch.where(live[..., None], coef.movedim(1, 0), 0.0)
    coef = coef * _chebyshev_signs(m_max, dev)[:, None, None]

    def eval_ff(phi):
        # F(phi) = a0 phi + sum_k a_k / k sin(k phi) - u a0 pi and f = F':
        # sin and cos by one recurrence from their values at k = -1 and 0,
        # summed in order: where the solve stops follows F's rounding
        cos_phi = torch.cos(phi.to(torch.float64)).to(torch.float32)
        sin_phi = safe_sqrt(1.0 - cos_phi * cos_phi)  # 0 once cos_phi rounds to 1
        F, f = _RecurrenceSeries.apply(
            cos_phi[:, None], torch.stack([-sin_phi, cos_phi], -1),
            torch.stack([torch.zeros_like(phi), torch.ones_like(phi)], -1),
            coef, None, torch.stack([a0 * phi, a0], -1)).unbind(-1)
        return F - u * a0 * math.pi, f

    a = torch.zeros_like(u)
    b = torch.full_like(u, math.pi)
    phi = torch.full_like(u, 0.5 * math.pi)
    for _ in range(_NEWTON_ITERS):
        F, f = eval_ff(phi)
        pos = F > 0
        b = torch.where(pos, phi, b)
        a = torch.where(pos, a, phi)
        phi_new = phi - F / torch.where(f == 0, 1.0, f)
        oob = ~((phi_new > a) & (phi_new < b))
        phi_new = torch.where(oob, 0.5 * (a + b), phi_new)
        done = (torch.abs(F) < 1e-6) | (b - a < 1e-6)
        phi = torch.where(done, phi, phi_new)
    _, f = eval_ff(phi)
    phi = torch.where(flip, 2.0 * math.pi - phi, phi)
    pdf = torch.where(a0 > 0, f / (2.0 * math.pi * torch.where(a0 == 0, 1.0, a0)),
                      0.0)
    return f, pdf, phi


def _invert_segment_integral(f0, f1, d0, d1, u):
    """Solve Fhat(t) = u on one spline segment (interpolation.cpp:130-167).
    Returns (t, fhat), Fhat the Horner-form antiderivative of the cubic."""
    t_lin = torch.where(
        f0 != f1,
        (f0 - safe_sqrt(f0 * f0 + 2.0 * u * (f1 - f0)))
        / torch.where(f0 == f1, 1.0, f0 - f1),
        u / torch.where(f0 == 0, 1.0, f0))

    def ff(t):
        Fhat = t * (f0 + t * (0.5 * d0 + t * ((1.0 / 3.0) * (-2 * d0 - d1)
                    + f1 - f0 + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                    + t * (d0 + d1 + 2 * (f0 - f1))))
        return Fhat, fhat

    a = torch.zeros_like(u)
    b = torch.ones_like(u)
    t = t_lin
    for _ in range(_NEWTON_ITERS):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        Fhat, fhat = ff(t)
        done = (torch.abs(Fhat - u) < 1e-6) | (b - a < 1e-6)
        below = Fhat - u < 0
        a2 = torch.where(below, t, a)
        b2 = torch.where(below, b, t)
        t2 = t - (Fhat - u) / torch.where(fhat == 0, 1.0, fhat)
        a = torch.where(done, a, a2)
        b = torch.where(done, b, b2)
        t = torch.where(done, t, t2)
    t = torch.clamp(t, 0.0, 1.0)
    _, fhat = ff(t)
    return t, fhat


def _fd_derivs(f0, f1, fm1, fp2, x0, x1, xm1, xp2, has_prev, has_next):
    width = x1 - x0
    d0 = torch.where(has_prev,
                     width * (f1 - fm1) / torch.where(has_prev, x1 - xm1, 1.0),
                     f1 - f0)
    d1 = torch.where(has_next,
                     width * (fp2 - f0) / torch.where(has_next, xp2 - x0, 1.0),
                     f1 - f0)
    return d0, d1


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u, row_off=0):
    """SampleCatmullRom2D (interpolation.cpp:175-253) over lanes.  nodes1
    [n1], nodes2 [n2], values and cdf [rows, n2] (row_off [...] selects a
    table of n1 rows among several stacked ones), alpha and u [...].
    Returns (x, fval, pdf)."""
    n1, n2 = nodes1.shape[0], nodes2.shape[0]
    dev = alpha.device
    off1, w1, valid = catmull_rom_weights(nodes1, alpha)
    rows = (torch.clamp(off1[..., None] + torch.arange(4, device=dev), 0, n1 - 1)
            + torch.as_tensor(row_off, device=dev)[..., None])

    def interp(tab, idx):
        v = tab[rows, torch.clamp(idx, 0, n2 - 1)[..., None]]
        return torch.sum(v * w1, -1)

    maximum = interp(cdf, torch.full(alpha.shape, n2 - 1, dtype=torch.int64,
                                     device=dev))
    u = u * maximum
    lo = torch.zeros(alpha.shape, dtype=torch.int64, device=dev)
    hi = torch.full(alpha.shape, n2 - 1, dtype=torch.int64, device=dev)
    for _ in range(int(np.ceil(np.log2(max(n2, 2)))) + 1):
        mid = (lo + hi) // 2
        below = interp(cdf, mid) <= u
        lo = torch.where(below, torch.maximum(mid, lo), lo)
        hi = torch.where(below, hi, torch.minimum(mid, hi))
    idx = torch.clamp(lo, 0, n2 - 2)

    f0 = interp(values, idx)
    f1 = interp(values, idx + 1)
    x0 = nodes2[idx]
    x1 = nodes2[idx + 1]
    width = x1 - x0
    u_seg = (u - interp(cdf, idx)) / torch.where(width == 0, 1.0, width)
    has_prev = idx > 0
    has_next = idx + 2 < n2
    fm1 = interp(values, torch.clamp(idx - 1, min=0))
    fp2 = interp(values, torch.clamp(idx + 2, max=n2 - 1))
    xm1 = nodes2[torch.clamp(idx - 1, min=0)]
    xp2 = nodes2[torch.clamp(idx + 2, max=n2 - 1)]
    d0, d1 = _fd_derivs(f0, f1, fm1, fp2, x0, x1, xm1, xp2, has_prev, has_next)
    t, fhat = _invert_segment_integral(f0, f1, d0, d1, u_seg)
    x = x0 + width * t
    pdf = torch.where(valid & (maximum > 0),
                      fhat / torch.where(maximum == 0, 1.0, maximum), 0.0)
    return x, torch.where(valid, fhat, 0.0), pdf


def catmull_rom_interp_2d(nodes1, nodes2, values, alpha, x, row_off=0):
    """The tensor-product spline's value at (alpha, x), the Sr(rho, r)
    lookup; row_off [...] as in sample_catmull_rom_2d."""
    n1, n2 = nodes1.shape[0], nodes2.shape[0]
    dev = alpha.device
    off1, w1, v1 = catmull_rom_weights(nodes1, alpha)
    off2, w2, v2 = catmull_rom_weights(nodes2, x)
    ar = torch.arange(4, device=dev)
    rows = (torch.clamp(off1[..., None] + ar, 0, n1 - 1)
            + torch.as_tensor(row_off, device=dev)[..., None])
    cols = torch.clamp(off2[..., None] + ar, 0, n2 - 1)
    v = values[rows[..., :, None], cols[..., None, :]]  # [..., 4, 4]
    val = torch.sum(v * w1[..., :, None] * w2[..., None, :], (-2, -1))
    return torch.where(v1 & v2, val, 0.0)


# ---- host (numpy) table builders ----

def integrate_catmull_rom_np(x, values):
    """(interpolation.cpp:255-283) -> (total, cdf [..., n]); values [..., n]."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    n = x.shape[-1]
    cdf = np.zeros(v.shape, np.float64)
    total = np.zeros(v.shape[:-1], np.float64)
    for i in range(n - 1):
        x0, x1 = x[i], x[i + 1]
        f0, f1 = v[..., i], v[..., i + 1]
        width = x1 - x0
        d0 = width * (f1 - v[..., i - 1]) / (x1 - x[i - 1]) if i > 0 else f1 - f0
        d1 = (width * (v[..., i + 2] - f0) / (x[i + 2] - x0) if i + 2 < n
              else f1 - f0)
        total = total + ((d0 - d1) * (1.0 / 12.0) + (f0 + f1) * 0.5) * width
        cdf[..., i + 1] = total
    return total, cdf


def invert_catmull_rom_np(x, values, u):
    """(interpolation.cpp:285-345) the scalar inverse of a monotone spline."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    n = len(x)
    if not (u > v[0]):
        return float(x[0])
    if not (u < v[n - 1]):
        return float(x[n - 1])
    i = min(max(int(np.searchsorted(v, u, side="right") - 1), 0), n - 2)
    x0, x1 = x[i], x[i + 1]
    f0, f1 = v[i], v[i + 1]
    width = x1 - x0
    d0 = width * (f1 - v[i - 1]) / (x1 - x[i - 1]) if i > 0 else f1 - f0
    d1 = width * (v[i + 2] - f0) / (x[i + 2] - x0) if i + 2 < n else f1 - f0
    a, b, t = 0.0, 1.0, 0.5
    for _ in range(64):
        if not (a < t < b):
            t = 0.5 * (a + b)
        t2, t3 = t * t, t * t * t
        Fhat = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
                + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
        fhat = ((6 * t2 - 6 * t) * f0 + (-6 * t2 + 6 * t) * f1
                + (3 * t2 - 4 * t + 1) * d0 + (3 * t2 - 2 * t) * d1)
        if abs(Fhat - u) < 1e-6 or b - a < 1e-6:
            break
        if Fhat - u < 0:
            a = t
        else:
            b = t
        t -= (Fhat - u) / fhat
    return float(x0 + t * width)


def catmull_rom_np(x, values, xq):
    """The spline's value at xq (interpolation.cpp:39-59), on the host."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    n = len(x)
    if not (xq >= x[0] and xq <= x[-1]):
        return 0.0
    i = min(max(int(np.searchsorted(x, xq, side="right") - 1), 0), n - 2)
    x0, x1 = x[i], x[i + 1]
    f0, f1 = v[i], v[i + 1]
    width = x1 - x0
    d0 = width * (f1 - v[i - 1]) / (x1 - x[i - 1]) if i > 0 else f1 - f0
    d1 = width * (v[i + 2] - f0) / (x[i + 2] - x0) if i + 2 < n else f1 - f0
    t = (xq - x0) / width
    t2, t3 = t * t, t ** 3
    return float((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
                 + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
