"""The rest of the port's tensor functions against the JAX package on the
CPU, one table a family (manipulation, logic, search, stat, linalg,
creation): (id, name, args, kwargs, tolerance, the port's dtype where it
differs by rule). Integer, bool, index and search results exactly; fp32
results within rtol 1e-5 / atol 1e-6. Factorizations (``eig``, ``eigh``,
``qr``, ``svd``, ``lu``) are unique only up to signs or order: they are
held by reconstruction and invariants. Also ``einsum``, the TensorArray
functions, the attributes, and the coverage of the surface: every public
name of ``paddle_tpu.tensor`` and every top-level ``paddle_tpu`` function
that comes from it exists in the port and is callable; ``_UNPORTED`` is
gone."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as jtensor
import paddle_tpu_torch as pt
import paddle_tpu_torch.tensor as ttensor
from torch_tensor_parity import (ANY, ANY2, B3, BOOL, BOOL2, C34, EXACT, F32,
                                 I64, INTS, INTS2, POS, SPD, SPECIAL, SQ,
                                 TIES, V3, assert_same, host, jx, row_id,
                                 run_row, tx)

IDX = np.array([2, 0, 1], "int64")
IDX2 = np.array([[0, 2], [1, 1], [2, 0]], "int64")
ND_IDX = np.array([[0, 1], [2, 3], [1, 0]], "int64")
SORTED = np.array([-1.0, 0.0, 0.5, 2.0], "float32")
B24 = np.arange(24, dtype="float32").reshape(2, 3, 4)
U8 = np.array([3, 1, 3, 0, 2, 3, 1], "int64")

MANIPULATION = [
    ("reshape", "reshape", (ANY, [4, 3]), {}, EXACT, None),
    ("flatten", "flatten", (B24,), dict(start_axis=1), EXACT, None),
    ("transpose", "transpose", (B24, [2, 0, 1]), {}, EXACT, None),
    ("moveaxis", "moveaxis", (B24, 0, 2), {}, EXACT, None),
    ("swapaxes", "swapaxes", (B24, 0, 2), {}, EXACT, None),
    ("t", "t", (ANY,), {}, EXACT, None),
    ("squeeze", "squeeze", (ANY[:, :1],), dict(axis=[0, 1]), EXACT, None),
    ("unsqueeze", "unsqueeze", (ANY,), dict(axis=[0, 3]), EXACT, None),
    ("concat", "concat", ([ANY, ANY2],), dict(axis=1), EXACT, None),
    ("stack", "stack", ([ANY, ANY2],), dict(axis=2), EXACT, None),
    ("unstack", "unstack", (B24,), dict(axis=1), EXACT, None),
    ("unbind", "unbind", (B24,), dict(axis=2), EXACT, None),
    ("split", "split", (ANY, [1, -1]), dict(axis=1), EXACT, None),
    ("chunk", "chunk", (ANY, 2), dict(axis=1), EXACT, None),
    ("tensor_split", "tensor_split", (ANY, 3), dict(axis=1), EXACT, None),
    ("tensor_split_idx", "tensor_split", (ANY, [1, 3]), dict(axis=1),
     EXACT, None),
    ("slice", "slice", (B24, [0, 2], [0, 1], [1, 3]), {}, EXACT, None),
    ("strided_slice", "strided_slice", (B24, [1, 2], [0, 0], [3, 4],
                                        [2, 3]), {}, EXACT, None),
    ("strided_slice_neg", "strided_slice", (B24, [2], [3], [-5], [-2]), {},
     EXACT, None),
    ("expand", "expand", (ANY[:1],), dict(shape=[2, 3, 4]), EXACT, None),
    ("expand_keep", "expand", (ANY[:, :1],), dict(shape=[-1, 4]), EXACT,
     None),
    ("expand_as", "expand_as", (ANY[:1], B24), {}, EXACT, None),
    ("broadcast_to", "broadcast_to", (V3[:, None],), dict(shape=[3, 5]),
     EXACT, None),
    ("broadcast_tensors", "broadcast_tensors", ([ANY[:1], V3[:, None]],), {},
     EXACT, None),
    ("tile", "tile", (ANY, [2, 1]), {}, EXACT, None),
    ("repeat_interleave", "repeat_interleave", (ANY, 2), dict(axis=1),
     EXACT, None),
    ("repeat_interleave_flat", "repeat_interleave", (ANY, 2), {}, EXACT,
     None),
    ("repeat_interleave_tensor", "repeat_interleave",
     (ANY, np.array([1, 0, 2], "int64")), dict(axis=0), EXACT, None),
    ("flip", "flip", (B24, [0, 2]), {}, EXACT, None),
    ("rot90", "rot90", (ANY,), dict(k=3), EXACT, None),
    ("roll", "roll", (ANY, 1), {}, EXACT, None),
    ("roll_axes", "roll", (B24, [1, -2]), dict(axis=[0, 2]), EXACT, None),
    ("gather", "gather", (ANY, IDX), {}, EXACT, None),
    ("gather_ax1", "gather", (ANY, IDX2), dict(axis=1), EXACT, None),
    ("gather_nd", "gather_nd", (ANY, ND_IDX), {}, EXACT, None),
    ("take_along_axis", "take_along_axis", (ANY, IDX2, 1), {}, EXACT, None),
    ("put_along_axis", "put_along_axis", (ANY, IDX2, ANY2[:, :2], 1), {},
     EXACT, None),
    ("put_along_axis_add", "put_along_axis", (ANY, IDX2[:, :1], 2.0, 1),
     dict(reduce="add"), F32, None),
    ("put_along_axis_mul", "put_along_axis", (ANY, IDX2, 3.0, 1),
     dict(reduce="mul"), F32, None),
    ("scatter", "scatter", (ANY, IDX[:2], ANY2[:2]), {}, EXACT, None),
    ("scatter_add", "scatter", (ANY, np.array([1, 1], "int64"), ANY2[:2]),
     dict(overwrite=False), F32, None),
    ("scatter_nd", "scatter_nd", (ND_IDX, V3, [3, 4]), {}, F32, None),
    ("scatter_nd_add", "scatter_nd_add", (ANY, ND_IDX, V3), {}, F32, None),
    ("index_select", "index_select", (ANY, IDX[:2]), dict(axis=0), EXACT,
     None),
    ("index_select_ax1", "index_select", (ANY, IDX), dict(axis=1), EXACT,
     None),
    ("index_sample", "index_sample", (ANY, IDX2), {}, EXACT, None),
    ("index_add", "index_add", (ANY, np.array([0, 2, 0], "int64"), 0,
                                ANY2), {}, F32, None),
    ("index_put", "index_put", (ANY, (IDX[:2], IDX[1:]), V3[:2]), {},
     EXACT, None),
    ("index_put_acc", "index_put", (ANY, (IDX[:2], IDX[:2]), V3[:2]),
     dict(accumulate=True), F32, None),
    ("masked_select", "masked_select", (ANY, BOOL), {}, EXACT, None),
    ("masked_fill", "masked_fill", (ANY, BOOL, -7.0), {}, EXACT, None),
    ("masked_scatter", "masked_scatter", (ANY, BOOL, ANY2), {}, EXACT, None),
    ("unique", "unique", (INTS,), {}, EXACT, None),
    ("unique_all", "unique", (INTS,), dict(return_index=True,
                                          return_inverse=True,
                                          return_counts=True), EXACT, None),
    ("unique_axis", "unique", (np.concatenate([INTS[:2], INTS[:1]]),),
     dict(axis=0, return_counts=True), EXACT, None),
    ("unique_consecutive", "unique_consecutive", (TIES,),
     dict(return_inverse=True, return_counts=True), EXACT, None),
    ("unique_consecutive_axis", "unique_consecutive",
     (np.array([[1, 1], [1, 1], [2, 0], [1, 1]], "int64"),),
     dict(axis=0, return_counts=True), EXACT, None),
    ("as_complex", "as_complex", (B24[..., :2],), {}, EXACT, None),
    ("as_real", "as_real", (C34,), {}, EXACT, None),
    ("view", "view", (ANY, [2, 6]), {}, EXACT, None),
    ("view_as", "view_as", (ANY, B24[0].T), {}, EXACT, None),
    ("unfold", "unfold", (B24, 2, 2, 1), {}, EXACT, None),
    ("pad_full", "pad", (ANY, [1, 0, 2, 1]), dict(value=3.0), EXACT, None),
    ("pad_nchw", "pad", (B24[None], [1, 2, 0, 1]), {}, EXACT, None),
    *((f"pad_{m}", "pad", (B24[None], [2, 1, 1, 2]), dict(mode=m), EXACT,
       None) for m in ("reflect", "replicate", "circular")),
    ("tensordot", "tensordot", (B24, B24[0]), dict(axes=[[1, 2], [0, 1]]),
     F32, None),
    ("tensordot_int", "tensordot", (ANY, ANY2.T), dict(axes=1), F32, None),
    ("crop", "crop", (B24,), dict(shape=[1, 2, -1], offsets=[1, 1, 1]),
     EXACT, None),
    ("shard_index", "shard_index", (np.array([[1], [6], [12], [19]],
                                             "int64"), 20, 2, 1), {}, EXACT,
     None),
]

LOGIC = [
    *((n, n, (ANY, ANY2), {}, EXACT, None)
      for n in ("equal", "not_equal", "greater_than", "greater_equal",
                "less_than", "less_equal")),
    ("equal_int_scalar", "equal", (INTS, 1), {}, EXACT, None),
    *((n, n, (BOOL, BOOL2), {}, EXACT, None)
      for n in ("logical_and", "logical_or", "logical_xor")),
    ("logical_not", "logical_not", (BOOL,), {}, EXACT, None),
    ("logical_and_int", "logical_and", (INTS, INTS2), {}, EXACT, None),
    *((n, n, (INTS, INTS2), {}, EXACT, None)
      for n in ("bitwise_and", "bitwise_or", "bitwise_xor")),
    ("bitwise_and_i64", "bitwise_and", (I64, I64 * 3), {}, EXACT, None),
    ("bitwise_not", "bitwise_not", (INTS,), {}, EXACT, None),
    ("bitwise_not_bool", "bitwise_not", (BOOL,), {}, EXACT, None),
    ("left_shift", "bitwise_left_shift", (INTS, np.abs(INTS2)), {}, EXACT,
     None),
    ("right_shift", "bitwise_right_shift", (INTS * 7, np.abs(INTS2)), {},
     EXACT, None),
    ("equal_all", "equal_all", (ANY, ANY.copy()), {}, EXACT, None),
    ("equal_all_diff", "equal_all", (ANY, ANY2), {}, EXACT, None),
    ("equal_all_shape", "equal_all", (ANY, ANY[:2]), {}, EXACT, None),
    ("allclose", "allclose", (ANY, ANY + 1e-7), {}, EXACT, None),
    ("allclose_nan", "allclose", (SPECIAL, SPECIAL), dict(equal_nan=True),
     EXACT, None),
    ("isclose", "isclose", (ANY, ANY + ANY2 * 1e-5), dict(rtol=1e-5,
                                                          atol=1e-6), EXACT,
     None),
    ("is_empty", "is_empty", (ANY[:0],), {}, EXACT, None),
]

SEARCH = [
    ("argmax", "argmax", (TIES,), {}, EXACT, None),
    ("argmax_ax1_keep", "argmax", (TIES,), dict(axis=1, keepdim=True),
     EXACT, None),
    ("argmin_ax0", "argmin", (TIES,), dict(axis=0), EXACT, None),
    ("argsort", "argsort", (TIES,), {}, EXACT, None),
    ("argsort_desc", "argsort", (TIES,), dict(descending=True), EXACT, None),
    ("argsort_ax0", "argsort", (TIES,), dict(axis=0), EXACT, None),
    ("sort", "sort", (TIES,), {}, EXACT, None),
    ("sort_desc_nan", "sort", (SPECIAL,), dict(descending=True), EXACT,
     None),
    ("topk", "topk", (TIES, 2), {}, EXACT, None),
    ("topk_small", "topk", (TIES, 3), dict(largest=False), EXACT, None),
    ("topk_ax0", "topk", (TIES, 2), dict(axis=0), EXACT, None),
    ("nonzero", "nonzero", (INTS,), {}, EXACT, None),
    ("nonzero_tuple", "nonzero", (INTS,), dict(as_tuple=True), EXACT, None),
    ("where", "where", (BOOL, ANY, ANY2), {}, EXACT, None),
    ("where_one", "where", (BOOL,), {}, EXACT, None),
    ("searchsorted", "searchsorted", (SORTED, ANY), {}, EXACT, None),
    ("searchsorted_right", "searchsorted", (SORTED, np.array(
        [0.0, 0.5, 3.0], "float32")), dict(right=True, out_int32=True),
     EXACT, None),
    ("searchsorted_nd", "searchsorted", (np.sort(ANY, 1), ANY2), {}, EXACT,
     None),
    ("bucketize", "bucketize", (ANY, SORTED), {}, EXACT, None),
    ("bucketize_right", "bucketize", (SORTED, SORTED), dict(right=True),
     EXACT, None),
    ("masked_select", "masked_select", (ANY, BOOL), {}, EXACT, None),
    ("kthvalue", "kthvalue", (TIES, 2), {}, EXACT, None),
    ("kthvalue_keep", "kthvalue", (TIES, 3), dict(axis=0, keepdim=True),
     EXACT, None),
    ("mode", "mode", (TIES,), {}, EXACT, None),
    ("mode_ax0", "mode", (TIES,), dict(axis=0, keepdim=True), EXACT, None),
    ("index_fill", "index_fill", (ANY, IDX[:2], 1, -1.0), {}, EXACT, None),
]

STAT = [
    ("var", "var", (ANY,), {}, F32, None),
    ("var_biased_ax1", "var", (ANY,), dict(axis=1, unbiased=False), F32,
     None),
    ("var_keep", "var", (ANY,), dict(axis=[0, 1], keepdim=True), F32, None),
    ("var_int", "var", (INTS,), dict(axis=0), F32, None),
    ("std", "std", (ANY,), dict(axis=0), F32, None),
    ("std_biased", "std", (ANY,), dict(unbiased=False, keepdim=True), F32,
     None),
    ("median_even", "median", (TIES,), dict(axis=1), F32, None),
    ("median_all", "median", (ANY,), {}, F32, None),
    ("median_odd_keep", "median", (TIES,), dict(axis=0, keepdim=True), F32,
     None),
    ("median_min", "median", (TIES,), dict(axis=1, mode="min"), F32, None),
    ("median_int", "median", (INTS,), dict(axis=1), F32, None),
    ("nanmedian", "nanmedian", (SPECIAL,), dict(axis=1), F32, None),
    ("nanmedian_all", "nanmedian", (SPECIAL,), {}, F32, None),
    ("quantile", "quantile", (ANY, 0.3), {}, F32, None),
    ("quantile_ax1", "quantile", (ANY, [0.25, 0.5]), dict(axis=1), F32,
     None),
    *((f"quantile_{m}", "quantile", (ANY, 0.4), dict(axis=0,
                                                     interpolation=m),
       F32, None) for m in ("lower", "higher", "midpoint", "nearest")),
    ("quantile_keep", "quantile", (ANY, 0.7), dict(axis=[0, 1],
                                                   keepdim=True), F32, None),
    ("nanquantile", "nanquantile", (SPECIAL, 0.5), dict(axis=1), F32, None),
    ("numel", "numel", (B24,), {}, EXACT, None),
    ("histogram", "histogram", (ANY,), dict(bins=5), EXACT, None),
    ("histogram_range", "histogram", (ANY,), dict(bins=4, min=-1, max=1),
     EXACT, None),
    ("histogram_weight", "histogram", (ANY,), dict(bins=3, weight=POS),
     F32, "float64"),
    ("histogram_density", "histogram", (ANY,), dict(bins=6, density=True),
     F32, None),
    ("bincount", "bincount", (U8,), {}, EXACT, None),
    ("bincount_min", "bincount", (U8,), dict(minlength=7), EXACT, None),
    ("bincount_w", "bincount", (U8,), dict(weights=np.linspace(
        0, 1, 7).astype("float32")), F32, None),
    ("corrcoef", "corrcoef", (ANY,), {}, F32, None),
    ("cov", "cov", (ANY,), {}, F32, None),
    ("cov_cols", "cov", (ANY,), dict(rowvar=False, ddof=False), F32, None),
    ("mean", "mean", (ANY,), dict(axis=0), F32, None),
]

LINALG = [
    ("norm", "norm", (ANY,), {}, F32, None),
    ("norm_ax1", "norm", (ANY,), dict(axis=1, keepdim=True), F32, None),
    ("norm_fro_axes", "norm", (B24,), dict(p="fro", axis=[1, 2]), F32,
     None),
    ("norm_p1", "norm", (ANY,), dict(p=1, axis=0), F32, None),
    ("norm_p3", "norm", (ANY,), dict(p=3), F32, None),
    ("norm_inf", "norm", (ANY,), dict(p=np.inf, axis=1), F32, None),
    ("norm_ninf", "norm", (ANY,), dict(p=-np.inf), F32, None),
    ("norm_nuc", "norm", (ANY,), dict(p="nuc"), F32, None),
    ("vector_norm", "vector_norm", (ANY,), dict(p=2.0, axis=1), F32, None),
    ("matrix_norm", "matrix_norm", (B24,), {}, F32, None),
    ("matrix_norm_1", "matrix_norm", (SQ,), dict(p=1), F32, None),
    ("cond", "cond", (SPD,), {}, dict(rtol=1e-4, atol=1e-5), None),
    ("matrix_rank", "matrix_rank", (np.outer(V3, V3).astype("float32"),),
     {}, EXACT, "int64"),
    ("matrix_power", "matrix_power", (SQ, 3), {}, F32, None),
    ("matrix_power_neg", "matrix_power", (SPD, -2), {},
     dict(rtol=1e-4, atol=1e-6), None),
    ("det", "det", (SPD,), {}, F32, None),
    ("slogdet", "slogdet", (SQ,), {}, F32, None),
    ("inv", "inv", (SPD,), {}, F32, None),
    ("pinv", "pinv", (ANY,), {}, dict(rtol=1e-4, atol=1e-5), None),
    ("solve", "solve", (SPD, ANY[:, :2]), {}, dict(rtol=1e-4, atol=1e-6),
     None),
    ("triangular_solve", "triangular_solve", (np.triu(SPD), ANY), {},
     dict(rtol=1e-4, atol=1e-5), None),
    ("triangular_solve_lt", "triangular_solve", (np.tril(SPD), ANY),
     dict(upper=False, transpose=True, unitriangular=True),
     dict(rtol=1e-4, atol=1e-5), None),
    ("cholesky", "cholesky", (SPD,), {}, F32, None),
    ("cholesky_upper", "cholesky", (SPD,), dict(upper=True), F32, None),
    ("cholesky_solve", "cholesky_solve", (ANY[:, :2], np.linalg.cholesky(
        SPD).astype("float32")), {}, dict(rtol=1e-4, atol=1e-6), None),
    ("svdvals", "svdvals", (ANY,), {}, F32, None),
    ("eigvalsh", "eigvalsh", (SPD,), {}, F32, None),
    ("lstsq", "lstsq", (ANY.T, ANY2.T[:, :2]), {}, dict(rtol=1e-4,
                                                        atol=1e-5), "_"),
    ("multi_dot", "multi_dot", ([ANY, ANY2.T, SQ],), {}, F32, None),
    ("matrix_exp", "matrix_exp", (SQ * 0.5,), {}, dict(rtol=1e-5, atol=1e-5),
     None),
    ("corrcoef", "corrcoef", (ANY,), {}, F32, None),
    ("dist", "dist", (ANY, ANY2), {}, F32, None),
    ("dist_inf", "dist", (ANY, ANY2), dict(p=np.inf), F32, None),
    ("dist_0", "dist", (ANY, np.where(BOOL, ANY, ANY2)), dict(p=0), F32,
     None),
    ("cdist", "cdist", (ANY, ANY2[:2]), {}, F32, None),
    ("cdist_p1", "cdist", (B24[..., :3], B24[:, :2, :3] * 0.5),
     dict(p=1.0), F32, None),
    ("householder_product", "householder_product", (SQ, V3 * 0.1), {},
     dict(rtol=1e-5, atol=1e-5), None),
    ("cross", "cross", (SPD, SQ), dict(axis=0), F32, None),
]


def _lstsq_row(row):
    """lstsq's rank is int32 in JAX, int64 in the port."""
    _, name, args, kwargs, tol, _ = row
    j = paddle.linalg.lstsq(*jx(args), **kwargs)
    t = pt.linalg.lstsq(*tx(args), **kwargs)
    for k, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(host(b), host(a), **tol,
                                   err_msg=f"lstsq[{k}]")


@pytest.mark.parametrize("row", MANIPULATION, ids=row_id)
def test_manipulation_row_matches_jax(row):
    run_row(*row[1:])


@pytest.mark.parametrize("row", LOGIC, ids=row_id)
def test_logic_row_matches_jax(row):
    run_row(*row[1:])


@pytest.mark.parametrize("row", SEARCH, ids=row_id)
def test_search_row_matches_jax(row):
    run_row(*row[1:])


@pytest.mark.parametrize("row", STAT, ids=row_id)
def test_stat_row_matches_jax(row):
    run_row(*row[1:])


@pytest.mark.parametrize("row", LINALG, ids=row_id)
def test_linalg_row_matches_jax(row):
    if row[1] == "lstsq":
        return _lstsq_row(row)
    run_row(*row[1:], module="linalg")


def _t(a):
    return torch.from_numpy(np.array(a))


# factorizations: the port's results rebuild the input, and carry the
# invariants of the JAX package's (the same eigen / singular values)
def test_eig_and_eigvals_rebuild_and_match_jax_values():
    w, v = pt.linalg.eig(_t(SQ))
    rebuilt = v @ torch.diag(w) @ torch.linalg.inv(v)
    np.testing.assert_allclose(rebuilt.real.numpy(), SQ, rtol=1e-4,
                               atol=1e-5)
    jw = np.asarray(paddle.linalg.eig(paddle.to_tensor(SQ))[0].numpy())
    key = lambda z: (np.round(z.real, 4), np.round(z.imag, 4))  # noqa: E731
    np.testing.assert_allclose(sorted(w.numpy(), key=key),
                               sorted(jw, key=key), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        sorted(pt.linalg.eigvals(_t(SQ)).numpy(), key=key),
        sorted(jw, key=key), rtol=1e-4, atol=1e-5)
    assert w.dtype == torch.complex64


def test_eigh_rebuilds_with_orthonormal_vectors():
    w, v = pt.linalg.eigh(_t(SPD))
    jw, _ = paddle.linalg.eigh(paddle.to_tensor(SPD))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw.numpy()), **F32)
    np.testing.assert_allclose((v @ torch.diag(w) @ v.T).numpy(), SPD,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((v.T @ v).numpy(), np.eye(3), atol=1e-6)


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_rebuilds_and_r_matches_jax_up_to_signs(mode):
    a = ANY.T                                           # 4 x 3
    j = paddle.linalg.qr(paddle.to_tensor(a), mode=mode)
    t = pt.linalg.qr(_t(a), mode=mode)
    jr = np.asarray((j if mode == "r" else j[1]).numpy())
    tr = (t if mode == "r" else t[1]).numpy()
    assert jr.shape == tr.shape
    np.testing.assert_allclose(np.abs(tr), np.abs(jr), rtol=1e-5, atol=1e-5)
    if mode != "r":
        q = t[0]
        np.testing.assert_allclose((q @ t[1]).numpy(), a, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose((q.T @ q).numpy(), np.eye(q.shape[1]),
                                   atol=1e-6)


@pytest.mark.parametrize("full", [False, True])
def test_svd_rebuilds_and_matches_jax_values(full):
    u, s, vh = pt.linalg.svd(_t(ANY), full_matrices=full)
    ju, js, jvh = paddle.linalg.svd(paddle.to_tensor(ANY), full_matrices=full)
    assert (tuple(u.shape), tuple(vh.shape)) == (tuple(ju.shape),
                                                 tuple(jvh.shape))
    np.testing.assert_allclose(s.numpy(), np.asarray(js.numpy()), **F32)
    k = s.shape[0]
    np.testing.assert_allclose((u[:, :k] * s @ vh[:k]).numpy(), ANY,
                               rtol=1e-5, atol=1e-5)
    lu, ls, lv = pt.linalg.svd_lowrank(_t(ANY), q=2)
    assert tuple(lv.shape) == (4, 2)
    np.testing.assert_allclose(ls.numpy(), np.asarray(js.numpy())[:2], **F32)
    pu, ps, pv = pt.linalg.pca_lowrank(_t(ANY), q=2)
    jpu, jps, jpv = paddle.linalg.pca_lowrank(paddle.to_tensor(ANY), q=2)
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps.numpy()), **F32)


def test_lu_and_lu_unpack_rebuild_as_jax_does():
    lu_, piv = pt.linalg.lu(_t(SQ))
    jlu, jpiv = paddle.linalg.lu(paddle.to_tensor(SQ))
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv.numpy()))
    np.testing.assert_allclose(lu_.numpy(), np.asarray(jlu.numpy()), **F32)
    P, L, U = pt.linalg.lu_unpack(lu_, piv)
    jP, jL, jU = paddle.linalg.lu_unpack(jlu, jpiv)
    np.testing.assert_allclose(P.numpy(), np.asarray(jP.numpy()), atol=0)
    np.testing.assert_allclose((P @ L @ U).numpy(), SQ, rtol=1e-5,
                               atol=1e-5)
    _, _, info = pt.linalg.lu(_t(SQ), get_infos=True)
    assert info.dtype == torch.int32 and int(info) == 0


def test_ormqr_matches_jax():
    j = paddle.linalg.ormqr(paddle.to_tensor(SQ), paddle.to_tensor(V3 * .1),
                            paddle.to_tensor(ANY))
    t = pt.linalg.ormqr(_t(SQ), _t(V3 * .1), _t(ANY))
    assert_same(j, t, dict(rtol=1e-5, atol=1e-5), None, "ormqr")


EINSUM = [("ij,jk->ik", (ANY, ANY2.T)), ("bij,bjk->bik", (B3, B3.transpose(
    0, 2, 1))), ("ii->", (SQ,)), ("i,j->ij", (V3, V3)), ("bij->bj", (B3,))]


@pytest.mark.parametrize("eq,ops", EINSUM, ids=[e for e, _ in EINSUM])
def test_einsum_matches_jax(eq, ops):
    assert_same(paddle.einsum(eq, *jx(ops)), pt.einsum(eq, *tx(ops)), F32,
                None, eq)
    assert_same(paddle.einsum(eq, list(jx(ops))),
                pt.einsum(eq, list(tx(ops))), F32, None, eq + " list")


CREATION = [
    ("logspace", "logspace", (0, 2, 5), {}, F32, None),
    ("logspace_base", "logspace", (1, 3, 3), dict(base=2.0), F32, None),
    ("meshgrid", "meshgrid", (V3, np.arange(2, dtype="float32")), {}, EXACT,
     None),
    ("diagflat", "diagflat", (ANY[:2],), dict(offset=1), EXACT, None),
    ("tril_indices", "tril_indices", (4, 3, -1), {}, EXACT, None),
    ("triu_indices", "triu_indices", (3, 4, 1), {}, EXACT, None),
    ("complex", "complex", (ANY, ANY2), {}, EXACT, None),
    ("polar", "polar", (POS, ANY), {}, F32, None),
]


@pytest.mark.parametrize("row", CREATION, ids=row_id)
def test_creation_row_matches_jax(row):
    _, name, args, kwargs, tol, dtype = row
    if name in ("logspace", "tril_indices", "triu_indices"):
        kwargs = dict(kwargs)
        j = getattr(paddle, name)(*args, **kwargs)
        t = getattr(pt, name)(*args, device="cpu", **kwargs)
        assert_same(j, t, tol, dtype, name)
        return
    run_row(name, args, kwargs, tol, dtype)


def test_tensor_array_functions_and_attributes():
    arr = pt.create_array("float32", [ANY], device="cpu")
    arr = pt.array_write(_t(ANY2), 2, arr)
    assert arr[1] is None and pt.array_read(arr, 2) is arr[2]
    assert pt.array_length(arr).item() == 3 == paddle.array_length(
        paddle.array_write(paddle.to_tensor(ANY2), 2, paddle.create_array(
            "float32", [ANY]))).item()
    assert pt.array_length(arr).dtype == torch.int64
    assert pt.create_tensor("int32", device="cpu").dtype == torch.int32
    x = _t(B24)
    assert pt.shape(x).tolist() == [2, 3, 4] and pt.shape(x).dtype == \
        torch.int64
    assert pt.rank(x).item() == 3
    assert pt.tensor.attribute.is_floating_point_fn(x)
    assert pt.tensor.attribute.is_integer_fn(_t(INTS))
    assert pt.tensor.attribute.is_complex_fn(_t(C34))


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and n != "annotations"}


def test_every_public_name_of_paddle_tensor_is_ported():
    assert not hasattr(ttensor, "_UNPORTED")
    for name in sorted(_public(jtensor)):
        j = getattr(jtensor, name)
        assert hasattr(ttensor, name), f"paddle.tensor.{name} is missing"
        t = getattr(ttensor, name)
        if callable(j):
            assert callable(t), f"paddle.tensor.{name} is not callable"
        else:
            assert type(t).__name__ == type(j).__name__, name
    # the top-level functions the JAX package takes from paddle.tensor
    for name in sorted(_public(paddle)):
        j = getattr(paddle, name)
        if callable(j) and getattr(jtensor, name, None) is j:
            assert callable(getattr(pt, name, None)), \
                f"paddle.{name} is missing at the port's top level"
    for name in importlib.import_module("paddle_tpu.linalg").__all__:
        assert callable(getattr(pt.linalg, name, None)), \
            f"paddle.linalg.{name} is missing"
    with pytest.raises(AttributeError):
        ttensor.no_such_function
