"""Unrolled small-matrix SPD linear algebra, batched and branch-free; the
PyTorch counterpart of ``monorun_tpu/ops/linalg_small.py``.

The PnP solver only factorises SPD matrices (damped Gauss-Newton and
Tikhonov-regularised DLT normal matrices), so an unrolled Cholesky over
per-entry batch vectors is exact and never raises: negative pivots are
clamped, and ``spd_valid*`` reports matrices that are not comfortably
positive definite (the caller then substitutes the identity), as the JAX
version does. The ``*_packed`` forms take entry-major (n, n, batch)
matrices.
"""

from __future__ import annotations

from typing import List

import torch

Tensor = torch.Tensor

_EPS = 1e-20


def _chol_scalars(rows: List[List[Tensor]]) -> List[List[Tensor]]:
    """Cholesky recurrence on unpacked entries; returns lower L entries."""
    n = len(rows)
    l: List[List[Tensor]] = [[None] * n for _ in range(n)]  # type: ignore
    for j in range(n):
        s = rows[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        d = torch.sqrt(s.clamp(min=_EPS))
        l[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = rows[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d
    return l


def _solve_scalars(l: List[List[Tensor]], b: list) -> List[Tensor]:
    """Solve A x = b from unpacked L; entries of b may be Python floats."""
    n = len(l)
    inv_diag = [1.0 / l[i][i] for i in range(n)]
    y = []
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y.append(s * inv_diag[i])
    x: List[Tensor] = [None] * n  # type: ignore
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * inv_diag[i]
    return x


def _rows_packed(a: Tensor) -> List[List[Tensor]]:
    n = a.shape[0]
    return [[a[i, j] for j in range(n)] for i in range(n)]


def _rows(a: Tensor) -> List[List[Tensor]]:
    n = a.shape[-1]
    return [[a[..., i, j] for j in range(n)] for i in range(n)]


def spd_solve_packed(a: Tensor, b: Tensor) -> Tensor:
    """a (n, n, ...), b (n, ...) -> x (..., n)."""
    n = a.shape[0]
    x = _solve_scalars(_chol_scalars(_rows_packed(a)), [b[i] for i in range(n)])
    return torch.stack(x, dim=-1)


def _inverse(rows: List[List[Tensor]]) -> Tensor:
    n = len(rows)
    l = _chol_scalars(rows)
    cols = [
        _solve_scalars(l, [1.0 if i == j else 0.0 for i in range(n)])
        for j in range(n)
    ]
    return torch.stack(
        [torch.stack([cols[j][i] for j in range(n)], -1) for i in range(n)], -2
    )


def spd_inverse(a: Tensor) -> Tensor:
    """(..., n, n) -> (..., n, n)."""
    return _inverse(_rows(a))


def spd_inverse_packed(a: Tensor) -> Tensor:
    """Entry-major a (n, n, batch) -> (batch, n, n)."""
    return _inverse(_rows_packed(a))


def _valid(rows: List[List[Tensor]], rel: float) -> Tensor:
    n = len(rows)
    l = _chol_scalars(rows)
    tr = rows[0][0]
    for i in range(1, n):
        tr = tr + rows[i][i]
    floor = torch.sqrt((rel * tr / n).clamp(min=_EPS))
    ok = l[0][0] > floor
    for i in range(1, n):
        ok = ok & (l[i][i] > floor)
    for i in range(n):
        for j in range(n):
            ok = ok & torch.isfinite(rows[i][j])
    return ok


def spd_valid(a: Tensor, rel: float = 1e-9) -> Tensor:
    """True where A (..., n, n) is comfortably positive definite: every
    Cholesky pivot above a floor relative to the trace, all entries
    finite."""
    return _valid(_rows(a), rel)


def spd_valid_packed(a: Tensor, rel: float = 1e-9) -> Tensor:
    """Entry-major PD check: a (n, n, batch) -> (batch,) bool."""
    return _valid(_rows_packed(a), rel)
