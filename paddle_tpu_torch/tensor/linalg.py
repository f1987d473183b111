"""Linear algebra — port of ``paddle_tpu/tensor/linalg.py``.

``torch.linalg`` (LAPACK on the CPU, cuSOLVER / cuBLAS on the card) runs
each function; the products stay ``torch.matmul``. Factorizations are
unique only up to signs or order (``eig``, ``eigh``, ``qr``, ``svd``,
``lu``): the port's agree with the JAX package's by reconstruction and
invariants, not entry by entry. Where the JAX package computes a result
its own way, the port does the same: ``lstsq`` through the SVD (all four
results, on either device), ``cdist`` as the explicit difference (with
``1e-30`` under the root at ``p = 2``), ``norm``'s ``p`` rules and the
deterministic ``svd_lowrank`` / ``pca_lowrank`` (leading parts of the
full SVD).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dispatch import apply_op
from .math import bmm, cross as _cross, dot, matmul, mm  # noqa: F401


def _ax(a):
    if isinstance(a, (list, tuple)):
        return tuple(int(i) for i in a)
    return int(a)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Frobenius / 2-norm (``p`` None or ``"fro"``), the nuclear norm, the
    max / min of ``|x|`` (``p = ±inf``), else ``(Σ |x|^p)^(1/p)``; over
    every entry when ``axis`` is None (``keepdim`` then ignored)."""
    def f(v):
        if p is None or p == "fro":
            if axis is None:
                return torch.sqrt(torch.sum(torch.square(v)))
            return torch.sqrt(torch.sum(torch.square(v.abs()), _ax(axis),
                                        keepdim=keepdim))
        if p == "nuc":
            return torch.linalg.svdvals(v).sum(-1)
        if p == np.inf or p == -np.inf:
            red = torch.amax if p > 0 else torch.amin
            if axis is None:
                return red(v.abs())
            return red(v.abs(), _ax(axis), keepdim=keepdim)
        if axis is None:
            return torch.pow(torch.sum(torch.pow(v.abs(), p)), 1.0 / p)
        return torch.pow(torch.sum(torch.pow(v.abs(), p), _ax(axis),
                                   keepdim=keepdim), 1.0 / p)

    return apply_op(f, x, op_name="norm")


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return apply_op(lambda v: torch.linalg.matrix_norm(
        v, ord=p, dim=tuple(axis), keepdim=keepdim), x, op_name="matrix_norm")


def cond(x, p=None, name=None):
    return apply_op(lambda v: torch.linalg.cond(v, p), x, op_name="cond")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol`` times the largest
    (``tol`` is a relative tolerance, as the JAX package passes it)."""
    return apply_op(lambda v: torch.linalg.matrix_rank(
        v, rtol=tol, hermitian=hermitian), x, op_name="matrix_rank")


def matrix_power(x, n, name=None):
    return apply_op(lambda v: torch.linalg.matrix_power(v, n), x,
                    op_name="matrix_power")


def det(x, name=None):
    return apply_op(torch.linalg.det, x, op_name="det")


def slogdet(x, name=None):
    """``[sign, log|det|]`` stacked, as the JAX package returns them."""
    return apply_op(lambda v: torch.stack(torch.linalg.slogdet(v)), x,
                    op_name="slogdet")


def inv(x, name=None):
    return apply_op(torch.linalg.inv, x, op_name="inv")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op(lambda v: torch.linalg.pinv(v, rtol=rcond,
                                                hermitian=hermitian), x,
                    op_name="pinv")


def solve(x, y, name=None):
    return apply_op(torch.linalg.solve, x, y, op_name="solve")


def triangular_solve(x, y, upper=True, transpose=False,
                     unitriangular=False, name=None):
    """``x⁻¹ y`` (``xᵀ⁻¹ y`` with ``transpose``) for a triangular ``x``."""
    def f(a, b):
        if transpose:
            a, up = a.mT, not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return apply_op(f, x, y, op_name="triangular_solve")


def cholesky(x, upper=False, name=None):
    return apply_op(lambda v: torch.linalg.cholesky(v, upper=upper), x,
                    op_name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    """Solves ``A z = x`` given ``y``, the Cholesky factor of ``A``."""
    return apply_op(lambda b, c: torch.cholesky_solve(b, c, upper=upper),
                    x, y, op_name="cholesky_solve")


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factor and its 1-based int32 pivots (LAPACK's)."""
    outs = apply_op(lambda v: tuple(torch.linalg.lu_factor(v)), x,
                    op_name="lu")
    if get_infos:
        return outs[0], outs[1], torch.zeros((), dtype=torch.int32,
                                             device=x.device)
    return outs


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` of a packed LU factor and its pivots, with ``x = P L
    U`` (the JAX package's permutation, in ``x``'s dtype)."""
    return torch.lu_unpack(x, y)


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return apply_op(lambda v: torch.linalg.qr(v, mode="r")[1], x,
                        op_name="qr")
    return apply_op(lambda v: tuple(torch.linalg.qr(v, mode=mode)), x,
                    op_name="qr")


def svd(x, full_matrices=False, name=None):
    """``(U, S, VH)`` with ``x == U @ diag(S) @ VH``."""
    return apply_op(lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), x, op_name="svd")


def svdvals(x, name=None):
    return apply_op(torch.linalg.svdvals, x, op_name="svdvals")


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    u, s, vh = svd(x)
    v = vh.mT.conj()
    return u[..., :q], s[..., :q], v[..., :q]


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    qq = q if q is not None else min(6, *x.shape[-2:])

    def f(v):
        if center:
            v = v - v.mean(-2, keepdim=True)
        u, s, vh = torch.linalg.svd(v, full_matrices=False)
        return u[..., :qq], s[..., :qq], vh.mT[..., :qq]

    return apply_op(f, x, op_name="pca_lowrank")


def eig(x, name=None):
    return apply_op(lambda v: tuple(torch.linalg.eig(v)), x, op_name="eig")


def eigvals(x, name=None):
    return apply_op(torch.linalg.eigvals, x, op_name="eigvals")


def eigh(x, UPLO="L", name=None):
    return apply_op(lambda v: tuple(torch.linalg.eigh(v, UPLO=UPLO)), x,
                    op_name="eigh")


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO), x,
                    op_name="eigvalsh")


def _lstsq(a, b, rcond):
    """``jnp.linalg.lstsq`` through the SVD: the solution, the residuals'
    squared norms (only at full rank with more rows than columns, else
    empty), the rank and the singular values."""
    m, n = a.shape[-2:]
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(n, m)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = s >= rcond * s[0] if s.numel() else s > 0
    rank = mask.sum()
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    x = vh.mT.conj() @ (s_inv[:, None] * (u.mT.conj() @ b))
    if m > n and int(rank) == n:
        resid = torch.sum(torch.abs(b - a @ x) ** 2, 0)
    else:
        resid = torch.empty(0, dtype=s.dtype, device=a.device)
    return (x[:, 0] if vec else x), resid, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    return apply_op(lambda a, b: _lstsq(a, b, rcond), x, y, op_name="lstsq")


def multi_dot(x, name=None):
    return apply_op(lambda *vs: torch.linalg.multi_dot(vs), *x,
                    op_name="multi_dot")


def matrix_exp(x, name=None):
    return apply_op(torch.linalg.matrix_exp, x, op_name="matrix_exp")


def householder_product(x, tau, name=None):
    return apply_op(torch.linalg.householder_product, x, tau,
                    op_name="householder_product")


def corrcoef(x, rowvar=True, name=None):
    return apply_op(lambda v: torch.corrcoef(v if rowvar else v.mT), x,
                    op_name="corrcoef")


def cross(x, y, axis=9, name=None):
    return _cross(x, y, axis)


def dist(x, y, p=2, name=None):
    """The ``p``-norm of ``x - y`` flattened (0: the nonzero count, ±inf:
    the largest / smallest ``|x - y|``)."""
    return apply_op(lambda a, b: torch.linalg.vector_norm(
        (a - b).reshape(-1), ord=p), x, y, op_name="dist")


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def f(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
        return torch.pow(torch.sum(torch.pow(diff.abs(), p), -1), 1.0 / p)

    return apply_op(f, x, y, op_name="cdist")


def histogram_bin_edges(x, bins=100, min=0, max=0, name=None):
    """``np.histogram_bin_edges``: ``bins + 1`` float64 edges over
    ``[min, max]`` (the data's range when both are 0, widened by 0.5
    each way when it is one value)."""
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    else:
        lo, hi = float(min), float(max)
    return torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                          device=x.device)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    Q = householder_product(x, tau)

    def f(q, o):
        qm = q.mT if transpose else q
        return torch.matmul(qm, o) if left else torch.matmul(o, qm)

    return apply_op(f, Q, other, op_name="ormqr")
