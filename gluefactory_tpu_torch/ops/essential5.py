"""Batched 5-point essential-matrix minimal solver, Li-Hartley hidden
variable (counterpart of `gluefactory_tpu/ops/essential5.py`), in
`torch.linalg` on the inputs' device.

1. The nullspace basis of the 5 x 9 epipolar system (SVD): E = x B1 + y B2
   + z B3 + B4.
2. The 10 x 20 cubic constraint matrix (det E = 0 and 2 E E^T E -
   tr(E E^T) E = 0) over the 20 monomials of degree <= 3 in (x, y, z). Its
   entries are cubic forms in the basis' 36 numbers; the forms' terms are
   expanded once, symbolically, into the module's constant tables
   (`_TERMS`), and each call evaluates them as gathers, products and
   sums in a fixed order (the same result on every run).
3. Grouping the monomials by their (x, y) part gives the 10 x 10 matrix
   polynomial M(z) = M0 + z M1 + z^2 M2 + z^3 M3 over [x^3, x^2 y, x y^2,
   y^3, x^2, xy, y^2, x, y, 1]; its real roots z are those of det M(z),
   never expanded into coefficients.
4. The real roots by a sign scan of det M(z) (`slogdet` signs) over a
   512-point tan-warped grid of the whole line, then 46 bisection steps of
   each of the first 10 brackets.
5. (x, y) from the null vector of M(z) (SVD), then 3 Gauss-Newton steps on
   the 10 constraints.

Returns up to 10 candidate E per sample; unused root slots are NaN.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["essential_5pt", "MONOMIALS"]

# exponents of (x, y, z), by degree, so that the (x, y) grouping of step 3
# is a static gather
MONOMIALS = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0),
    (2, 0, 1), (1, 1, 1), (0, 2, 1),
    (1, 0, 2), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (0, 2, 0),
    (1, 0, 1), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_MONO_IDX = {m: i for i, m in enumerate(MONOMIALS)}
_XY_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
# [z degree k][(x, y) monomial j] -> the column of the 10 x 20 matrix that
# holds z^k's coefficient of M(z)[:, j]; 20 is a zero column
_Z_SCATTER = [[_MONO_IDX.get((mx, my, k), 20) for (mx, my) in _XY_MONOS] for k in range(4)]

_N_GRID = 512
_N_ROOTS = 10
_BISECT_ITERS = 46


# -- the symbolic expansion (module constants) --------------------------------
# A polynomial in (x, y, z) is {monomial: coefficient}; a coefficient is a
# polynomial in the basis' flat entries B[k * 9 + r * 3 + c]:
# {sorted tuple of entry indices: float}.


def _coef_mul(a: dict, b: dict) -> dict:
    out: dict = {}
    for ka, ca in a.items():
        for kb, cb in b.items():
            k = tuple(sorted(ka + kb))
            out[k] = out.get(k, 0.0) + ca * cb
    return out


def _coef_add(a: dict, b: dict, scale: float = 1.0) -> dict:
    out = dict(a)
    for k, c in b.items():
        out[k] = out.get(k, 0.0) + scale * c
    return out


def _poly_mul(a: dict, b: dict) -> dict:
    out: dict = {}
    for ma, ca in a.items():
        for mb, cb in b.items():
            m = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            out[m] = _coef_add(out.get(m, {}), _coef_mul(ca, cb))
    return out


def _poly_add(a: dict, b: dict, scale: float = 1.0) -> dict:
    out = dict(a)
    for m, c in b.items():
        out[m] = _coef_add(out.get(m, {}), c, scale)
    return out


def _constraint_polys() -> list:
    """The 10 constraints as polynomials with symbolic coefficients."""
    var_mono = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    E = [[{var_mono[k]: {(k * 9 + r * 3 + c,): 1.0} for k in range(4)} for c in range(3)]
         for r in range(3)]

    def dot3(u, v):
        return _poly_add(_poly_add(_poly_mul(u[0], v[0]), _poly_mul(u[1], v[1])),
                         _poly_mul(u[2], v[2]))

    def minor(a, b, c, d):
        return _poly_add(_poly_mul(a, b), _poly_mul(c, d), -1.0)

    det = _poly_add(_poly_add(_poly_mul(E[0][0], minor(E[1][1], E[2][2], E[1][2], E[2][1])),
                              _poly_mul(E[0][1], minor(E[1][0], E[2][2], E[1][2], E[2][0])), -1.0),
                    _poly_mul(E[0][2], minor(E[1][0], E[2][1], E[1][1], E[2][0])))
    EEt = [[dot3(E[i], E[j]) for j in range(3)] for i in range(3)]
    tr = _poly_add(_poly_add(EEt[0][0], EEt[1][1]), EEt[2][2])
    out = [det]
    for i in range(3):
        for j in range(3):
            acc = dot3(EEt[i], [E[0][j], E[1][j], E[2][j]])
            acc = {m: {k: 2.0 * v for k, v in c.items()} for m, c in acc.items()}
            out.append(_poly_add(acc, _poly_mul(tr, E[i][j]), -1.0))
    return out


def _terms():
    """(entry indices (T, 3), coefficients (T,), terms of each slot (200,
    S)): row i, monomial m of the constraint matrix is the sum of coef *
    B[a] B[b] B[c] over the terms listed in slot i * 20 + m, a slot's list
    padded with T (a zero term), so that the sums run in a fixed order."""
    idx, coef, slots = [], [], [[] for _ in range(200)]
    for i, poly in enumerate(_constraint_polys()):
        for m, c in poly.items():
            for k, v in c.items():
                if v != 0.0:
                    slots[i * 20 + _MONO_IDX[m]].append(len(idx))
                    idx.append(k)
                    coef.append(v)
    width = max(len(s) for s in slots)
    table = np.array([s + [len(idx)] * (width - len(s)) for s in slots], np.int64)
    return np.array(idx, np.int64), np.array(coef, np.float32), table


_TERMS = _terms()


# -- the solver ---------------------------------------------------------------


def _constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """basis (I, 4, 9) -> the constraint matrix (I, 10, 20)."""
    idx, coef, table = (torch.from_numpy(a).to(basis.device) for a in _TERMS)
    flat = basis.reshape(basis.shape[0], 36)
    prod = flat[:, idx[:, 0]] * flat[:, idx[:, 1]] * flat[:, idx[:, 2]] * coef
    prod = torch.cat([prod, torch.zeros_like(prod[:, :1])], dim=1)
    return prod[:, table].sum(-1).reshape(-1, 10, 20)


def _z_matrices(M: torch.Tensor) -> torch.Tensor:
    """(I, 10, 20) -> (4, I, 10, 10): M(z)'s coefficient of z^k."""
    padded = torch.cat([M, torch.zeros_like(M[..., :1])], dim=-1)
    cols = torch.tensor(_Z_SCATTER, device=M.device)
    return padded[..., cols].permute(2, 0, 1, 3)


def _eval_Mz(Ms: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """M(z) for z (I, R) with Ms (4, I, 10, 10): (I, R, 10, 10)."""
    M0, M1, M2, M3 = (m[:, None] for m in Ms)
    z = z[..., None, None]
    return M0 + z * (M1 + z * (M2 + z * M3))


def _det_sign(Mz: torch.Tensor) -> torch.Tensor:
    """The sign of det (0 where singular) without a host read."""
    return torch.linalg.slogdet(Mz).sign


def _real_roots(Ms: torch.Tensor, eps: float = 1e-3):
    """Up to 10 real roots (I, 10) of det M(z) and their validity: the first
    10 sign changes over a tan-warped grid of the whole line, each bisected
    46 times in the angle."""
    theta = torch.linspace(-math.pi / 2 + eps, math.pi / 2 - eps, _N_GRID, dtype=torch.float32,
                           device=Ms.device)
    n = Ms.shape[1]
    signs = _det_sign(_eval_Mz(Ms, torch.tan(theta).expand(n, _N_GRID)))  # (I, G)
    change = signs[:, 1:] * signs[:, :-1] <= 0  # a crossing or an exact zero
    positions = torch.arange(_N_GRID - 1, device=Ms.device).expand(n, -1)
    first = torch.where(change, positions, _N_GRID).topk(_N_ROOTS, dim=-1, largest=False).values
    valid = first < _N_GRID
    idx = torch.where(valid, first, 0)
    lo, hi = theta[idx], theta[idx + 1]
    s_lo = torch.gather(signs, 1, idx)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        same = _det_sign(_eval_Mz(Ms, torch.tan(mid))) * s_lo > 0
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    return torch.tan(0.5 * (lo + hi)), valid


_EXP = torch.tensor(MONOMIALS, dtype=torch.float32)  # (20, 3)


def _mono20(s: torch.Tensor):
    """The 20 monomials of s (..., 3) and their derivatives: (..., 20) and
    (..., 20, 3)."""
    exp = _EXP.to(s.device, s.dtype)
    powers = [torch.stack([s[..., v] ** e for e in range(4)], dim=-1) for v in range(3)]
    ints = exp.long()

    def mono(drop: int | None):
        out = torch.ones(s.shape[:-1] + (20,), dtype=s.dtype, device=s.device)
        for v in range(3):
            e = ints[:, v] - (1 if v == drop else 0)
            factor = powers[v][..., e.clamp(min=0)]
            if v == drop:
                factor = torch.where(e >= 0, factor * exp[:, v], torch.zeros_like(factor))
            out = out * factor
        return out

    return mono(None), torch.stack([mono(v) for v in range(3)], dim=-1)


def _polish(M: torch.Tensor, s: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Gauss-Newton steps of s = (x, y, z) (I, R, 3) on the residuals
    M @ mono20(s), M (I, 10, 20); a non-finite step is not taken."""
    eye = 1e-9 * torch.eye(3, dtype=s.dtype, device=s.device)
    M = M[:, None]
    for _ in range(iters):
        m, dm = _mono20(s)
        r = (M @ m[..., None])[..., 0]  # (I, R, 10)
        J = M @ dm  # (I, R, 10, 3)
        Jt = J.transpose(-1, -2)
        d = torch.linalg.solve_ex(Jt @ J + eye, (Jt @ r[..., None]))[0][..., 0]
        s = s - torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return s


def essential_5pt(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """p0, p1 (..., 5, 2) normalized image coordinates -> (..., 10, 3, 3)
    candidate essential matrices (unit Frobenius norm); unused slots NaN."""
    batch = p0.shape[:-2]
    p0, p1 = p0.reshape(-1, 5, 2), p1.reshape(-1, 5, 2)
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)],
                    dim=-1)  # (I, 5, 9)
    basis = torch.linalg.svd(A, full_matrices=True).Vh[:, 5:, :]  # (I, 4, 9)
    M = _constraint_matrix(basis)
    M = M / (torch.linalg.vector_norm(M, dim=-1, keepdim=True) + 1e-30)
    Ms = _z_matrices(M)
    z, valid = _real_roots(Ms)
    v = torch.linalg.svd(_eval_Mz(Ms, z)).Vh[..., 9, :]  # (I, 10, 10) null vectors
    w = v[..., 9]
    w = torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
    s = _polish(M, torch.stack([v[..., 7] / w, v[..., 8] / w, z], dim=-1))
    E = (s[..., 0:1] * basis[:, None, 0] + s[..., 1:2] * basis[:, None, 1]
         + s[..., 2:3] * basis[:, None, 2] + basis[:, None, 3])  # (I, 10, 9)
    E = E / (torch.linalg.vector_norm(E, dim=-1, keepdim=True) + 1e-30)
    E = torch.where(valid[..., None], E, torch.full_like(E, float("nan")))
    return E.reshape(batch + (_N_ROOTS, 3, 3))
