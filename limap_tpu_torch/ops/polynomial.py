"""Branch-free closed-form polynomial root solvers, batched over leading
dims: quadratics, one real root of a cubic (Cardano or trigonometric),
and the real roots of a quartic (Ferrari with a resolvent cubic, then a
few Newton steps).  Complex roots come back as NaN."""

from __future__ import annotations

import torch

_EPS = 1e-12


def _where_small(x: torch.Tensor) -> torch.Tensor:
    """``x`` with entries below _EPS in magnitude replaced by _EPS."""
    return torch.where(torch.abs(x) < _EPS, torch.full_like(x, _EPS), x)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_quadratic(a, b, c) -> torch.Tensor:
    """Real roots of a x^2 + b x + c; [..., 2] (NaN when complex)."""
    disc = b * b - 4 * a * c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    # the numerically stable form
    q = -0.5 * (b + torch.sign(b + (b == 0).to(b.dtype)) * s)
    r1 = q / _where_small(a)
    r2 = c / _where_small(q)
    nan = torch.full_like(r1, float("nan"))
    ok = disc >= 0
    return torch.stack([torch.where(ok, r1, nan), torch.where(ok, r2, nan)],
                       dim=-1)


def solve_cubic_real(b, c, d) -> torch.Tensor:
    """One real root of x^3 + b x^2 + c x + d (one always exists)."""
    # the depressed cubic t^3 + p t + q with x = t - b/3
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # disc > 0: one real root (Cardano)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cardano = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    # disc <= 0: three real roots; t = 2 sqrt(-p/3) cos(phi/3)
    r = torch.sqrt(torch.clamp(-p / 3.0, min=_EPS))
    r3 = torch.clamp(r ** 3, min=_EPS)
    phi = torch.arccos(torch.clamp(-q / (2.0 * r3), -1.0, 1.0))
    t_trig = 2.0 * r * torch.cos(phi / 3.0)

    return torch.where(disc > 0, t_cardano, t_trig) - b / 3.0


def _polish_quartic(roots, b, c, d, e, iters: int = 3) -> torch.Tensor:
    """Newton steps on roots of x^4 + b x^3 + c x^2 + d x + e (NaN roots
    stay NaN)."""
    for _ in range(iters):
        x = roots
        f = (((x + b) * x + c) * x + d) * x + e
        fp = ((4 * x + 3 * b) * x + 2 * c) * x + d
        roots = torch.where(torch.isnan(roots), roots, x - f / _where_small(fp))
    return roots


def solve_quartic_real(b, c, d, e) -> torch.Tensor:
    """Real roots of x^4 + b x^3 + c x^2 + d x + e; [..., 4], NaN pads.

    Ferrari: depress to y^4 + p y^2 + q y + r and factor it as
    (y^2 + a y + u)(y^2 - a y + v) with a = sqrt(2m), m a real root of
    the resolvent cubic.
    """
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b ** 3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b ** 4 / 256.0

    # the resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0, m > 0
    m = torch.clamp(solve_cubic_real(p, p * p / 4.0 - r, -q * q / 8.0),
                    min=_EPS)
    sqrt2m = torch.sqrt(2.0 * m)
    half = p / 2.0 + m
    shift = q / (2.0 * sqrt2m)
    one = torch.ones_like(b)
    ra = solve_quadratic(one, -sqrt2m, half + shift)
    rb = solve_quadratic(one, sqrt2m, half - shift)
    x = torch.cat([ra, rb], dim=-1) - b[..., None] / 4.0
    return _polish_quartic(x, b[..., None], c[..., None], d[..., None],
                           e[..., None])
