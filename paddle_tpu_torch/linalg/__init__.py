"""``paddle.linalg`` — port of ``paddle_tpu/linalg/__init__.py``: the
names of ``tensor/linalg.py`` (and ``cross`` of ``tensor/math.py``)."""
from ..tensor.linalg import (bmm, cdist, cholesky, cholesky_solve, cond,  # noqa: F401
                             corrcoef, det, dist, dot, eig, eigh, eigvals,
                             eigvalsh, householder_product, inv, lstsq, lu,
                             lu_unpack, matmul, matrix_exp, matrix_norm,
                             matrix_power, matrix_rank, mm, multi_dot, norm,
                             ormqr, pca_lowrank, pinv, qr, slogdet, solve, svd,
                             svd_lowrank, svdvals, triangular_solve,
                             vector_norm)
from ..tensor.math import cross  # noqa: F401

__all__ = [n for n in dir() if not n.startswith("_")]
