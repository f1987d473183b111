"""The remaining functional ops — port of ``paddle_tpu/nn/functional/
extras.py``: ``pairwise_distance``, ``diag_embed``, ``hsigmoid_loss``,
``margin_cross_entropy``, ``gather_tree``, ``affine_grid`` /
``grid_sample``, ``max_unpool1d`` / ``3d``, ``sparse_attention``,
``rnnt_loss``, ``class_center_sample`` and the in-place ``relu_`` /
``elu_`` / ``softmax_`` / ``tanh_``, each with the JAX package's
semantics (not those of a torch function of a similar name)."""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``(sum |x - y + eps|^p)^(1/p)`` over the last axis (epsilon added
    to |x - y|, as the JAX package does)."""
    return torch.pow(torch.pow((x - y).abs() + epsilon, p).sum(
        -1, keepdim=keepdim), 1.0 / p)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last axis of ``input`` as the ``offset`` diagonal of new (n, n)
    matrices placed at ``dim1`` (rows) and ``dim2`` (columns)."""
    k = input.shape[-1]
    n = k + abs(offset)
    out = input.new_zeros(tuple(input.shape[:-1]) + (n, n))
    idx = torch.arange(k, device=input.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = input
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    perm = [i for i in range(nd) if i not in (nd - 2, nd - 1)]
    for pos, src in sorted([(d1, nd - 2), (d2, nd - 1)]):
        perm.insert(pos, src)
    return out.permute(perm)


def _default_tree(num_classes):
    """The complete binary tree over ``num_classes`` leaves (internal
    nodes 0 … num_classes - 2 in heap order): each class's path of node
    ids (-1 past its end) and codes (1: the right child)."""
    n_nodes = num_classes - 1
    depth = max(int(math.ceil(math.log2(num_classes))), 1)
    table = np.full((num_classes, depth), -1, np.int64)
    codes = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node = c + n_nodes
        path = []
        while node > 0:
            parent = (node - 1) // 2
            path.append((parent, float(node == 2 * parent + 2)))
            node = parent
        for d, (nid, code) in enumerate(reversed(path)):
            if d < depth and nid < n_nodes:
                table[c, d] = nid
                codes[c, d] = code
    return torch.from_numpy(table), torch.from_numpy(codes)


def _hsigmoid(x, label, weight, bias, table, codes):
    """Hierarchical sigmoid: BCE with logits along each sample's path
    (``table`` node ids, -1 past the end; ``codes`` 1 for right), summed,
    (B, 1)."""
    valid = (table >= 0).to(x.dtype)
    tbl = table.clamp_min(0)
    logits = torch.einsum("bdf,bf->bd", weight[tbl], x)
    if bias is not None:
        logits = logits + bias[tbl]
    loss = torch.clamp_min(logits, 0) - logits * codes + torch.logaddexp(
        torch.zeros_like(logits), -logits.abs())
    return (loss * valid).sum(-1, keepdim=True)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """``HSigmoidLoss``'s loss with the given ``weight`` (num_classes - 1,
    feature) and ``bias``: the default complete binary tree, or a custom
    one from ``path_table`` / ``path_code`` (B, depth)."""
    if path_table is not None:
        table, codes = path_table.long(), path_code.to(input.dtype)
    else:
        table, codes = _default_tree(num_classes)
        flat = label.long().reshape(label.shape[0])
        table = table.to(input.device)[flat]
        codes = codes.to(device=input.device, dtype=input.dtype)[flat]
    return _hsigmoid(input, label, weight, bias, table, codes)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-style margin softmax: the target logit cos θ becomes
    cos(m1·θ + m2) - m3, all scaled by ``scale``; one process (the JAX
    package ignores ``group`` too)."""
    lbl = label.long()
    theta = torch.arccos(logits.clamp(-1 + 1e-7, 1 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    onehot = torch.nn.functional.one_hot(lbl, logits.shape[-1]) > 0
    scaled = torch.where(onehot, target, logits) * scale
    loss = -torch.log_softmax(scaled, -1).gather(1, lbl.unsqueeze(1))[:, 0]
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.softmax(scaled, -1)
    return loss


def gather_tree(ids, parents):
    """Beam-search backtrace (the reference's ``gather_tree`` op): ids and
    parents (T, B, beam), step t's token of beam j and the beam it grew
    from. Walks each final beam back from step T - 1 and returns the
    tokens of its path, int64 (T, B, beam). Plain device ops, no host
    read: it runs inside a CUDA graph."""
    ids = ids.long()
    parents = parents.long()
    T, B, K = ids.shape
    beams = torch.arange(K, device=ids.device).expand(B, K)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, beams)
        beams = torch.gather(parents[t], 1, beams)
    return torch.stack(out)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """2-D affine θ (N, 2, 3) → sampling grid (N, H, W, 2) in [-1, 1]."""
    N, _, H, W = [int(s) for s in (out_shape.tolist() if isinstance(
        out_shape, torch.Tensor) else out_shape)]

    def lin(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, dtype=theta.dtype,
                                  device=theta.device)
        return (torch.arange(n, dtype=theta.dtype, device=theta.device)
                * 2 + 1) / n - 1

    gy, gx = torch.meshgrid(lin(H), lin(W), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    return torch.einsum("nij,pj->npi", theta, base).reshape(N, H, W, 2)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at ``grid`` (N, h, w, 2) of (x, y) in [-1, 1]:
    bilinear or nearest (round half to even), zeros outside, or the
    border / reflection padding of the JAX package."""
    N, C, H, W = x.shape

    def unnorm(coord, size):
        if align_corners:
            return (coord + 1) / 2 * (size - 1)
        return ((coord + 1) * size - 1) / 2

    gx = unnorm(grid[..., 0], W)
    gy = unnorm(grid[..., 1], H)
    if padding_mode == "border":
        gx = gx.clamp(0, W - 1)
        gy = gy.clamp(0, H - 1)
    elif padding_mode == "reflection":
        gx = (torch.remainder(gx, 2 * (W - 1)) - (W - 1)).abs() if W > 1 \
            else gx * 0
        gy = (torch.remainder(gy, 2 * (H - 1)) - (H - 1)).abs() if H > 1 \
            else gy * 0
    n_idx = torch.arange(N, device=x.device).view(N, 1, 1)
    xc = x.permute(0, 2, 3, 1)                       # (N, H, W, C)

    def sample(xi, yi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = xc[n_idx, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid.unsqueeze(-1), out, torch.zeros_like(out))

    if mode == "nearest":
        out = sample(torch.round(gx).long(), torch.round(gy).long())
        return out.permute(0, 3, 1, 2)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    wx = (gx - x0).unsqueeze(-1)
    wy = (gy - y0).unsqueeze(-1)
    top = sample(x0, y0) * (1 - wx) + sample(x0 + 1, y0) * wx
    bot = sample(x0, y0 + 1) * (1 - wx) + sample(x0 + 1, y0 + 1) * wx
    return (top * (1 - wy) + bot * wy).permute(0, 3, 1, 2)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    from .pooling import max_unpool2d

    out = max_unpool2d(x.unsqueeze(2), indices.unsqueeze(2),
                       (1, kernel_size), (1, stride or kernel_size),
                       (0, padding), output_size=None if output_size is None
                       else [1, output_size[-1]])
    return out.squeeze(2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    """Each value of x written at its flat index into (od·oh·ow), zeros
    elsewhere; the output size ``(in - 1)·stride + kernel`` unless
    ``output_size`` says (padding ignored, as in the JAX package)."""
    ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
        else [kernel_size] * 3
    st = stride if isinstance(stride, (list, tuple)) else \
        ([stride] * 3 if stride else ks)
    n, c, d, h, w = x.shape
    if output_size is not None:
        od, oh, ow = [int(s) for s in output_size[-3:]]
    else:
        od = (d - 1) * st[0] + ks[0]
        oh = (h - 1) * st[1] + ks[1]
        ow = (w - 1) * st[2] + ks[2]
    flat = x.new_zeros((n, c, od * oh * ow))
    out = flat.scatter(2, indices.reshape(n, c, -1).long(),
                       x.reshape(n, c, -1))
    return out.reshape(n, c, od, oh, ow)


_CSR_MASK_CACHE: dict = {}


def _csr_allow_mask(offs, cols, device):
    """Dense (B, H, S, S) allow-mask from a CSR layout, built on the host
    and cached on the layout's bytes (training reuses one pattern)."""
    key = (offs.tobytes(), cols.tobytes(), str(device))
    hit = _CSR_MASK_CACHE.get(key)
    if hit is not None:
        return hit
    B, H, S = offs.shape[0], offs.shape[1], offs.shape[2] - 1
    allow = np.zeros((B * H, S, S), bool)
    offs2 = offs.reshape(B * H, S + 1)
    cols2 = cols.reshape(B * H, -1)
    for i in range(B * H):
        rows = np.repeat(np.arange(S), np.diff(offs2[i]))
        allow[i, rows, cols2[i, offs2[i, 0]:offs2[i, -1]]] = True
    mask = torch.from_numpy(allow.reshape(B, H, S, S)).to(device)
    if len(_CSR_MASK_CACHE) > 8:      # bound the cache
        _CSR_MASK_CACHE.clear()
    _CSR_MASK_CACHE[key] = mask
    return mask


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over the pairs a CSR layout allows (offset (B, H, S + 1),
    columns (B, H, nnz)), computed dense and masked, as the JAX package
    does: the layout is read on the host (the reference keeps it there).
    ``key_padding_mask`` (B, S) and ``attn_mask`` are additive (0 keeps,
    -1e30 drops). q / k / v (B, H, S, D)."""
    offs = sparse_csr_offset.detach().cpu().numpy().astype(np.int64)
    cols = sparse_csr_columns.detach().cpu().numpy().astype(np.int64)
    mask = _csr_allow_mask(offs, cols, query.device)
    d = query.shape[-1]
    sc = torch.einsum("bhsd,bhtd->bhst", query, key) / torch.sqrt(
        torch.tensor(d, dtype=torch.float32)).to(query.dtype)
    sc = sc.float()
    if key_padding_mask is not None:
        sc = sc + key_padding_mask[:, None, None, :].float()
    if attn_mask is not None:
        sc = sc + attn_mask.float()
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, -1).to(query.dtype)
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum("bhst,bhtd->bhsd", p, value)


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """The RNN-Transducer loss as the JAX package computes it: the lattice
    forward over anti-diagonals (T + U steps, each vectorised over u) in
    log space, -1e30 for minus infinity. logits (B, T, U + 1, V); labels
    (B, U). A nonzero ``fastemit_lambda`` raises (not implemented in the
    JAX package either)."""
    if fastemit_lambda:
        raise NotImplementedError(
            "rnnt_loss: fastemit_lambda != 0 is not supported (the FastEmit "
            "gradient-blending term is not implemented); pass 0.0")
    lp = torch.log_softmax(logits.float(), -1)
    B, T, U1, _ = lp.shape
    dev = lp.device
    blank_lp = lp[..., blank]                                # (B, T, U+1)
    if U1 > 1:
        lab_lp = lp[:, :, :U1 - 1, :].gather(
            3, labels.long()[:, None, :, None].expand(B, T, U1 - 1, 1))[..., 0]
    else:
        lab_lp = torch.full((B, T, 1), NEG_INF, device=dev)
    lab_lp = torch.cat([torch.full((B, T, 1), NEG_INF, device=dev), lab_lp],
                       2)
    u_ar = torch.arange(U1, device=dev)
    neg = torch.full((B, 1), NEG_INF, device=dev)
    alpha = torch.full((B, U1), NEG_INF, device=dev)
    diags = []
    for d in range(T + U1 - 1):
        tvec = d - u_ar
        on = (tvec >= 0) & (tvec < T)
        tc = tvec.clamp(0, T - 1)
        b_lp = blank_lp[:, (tvec - 1).clamp(0, T - 1), u_ar]
        from_blank = torch.where((tvec > 0).unsqueeze(0), alpha + b_lp,
                                 NEG_INF)
        l_lp = lab_lp[:, tc, u_ar]
        alpha_um1 = torch.cat([neg, alpha[:, :-1]], 1)
        from_label = torch.where((u_ar > 0).unsqueeze(0), alpha_um1 + l_lp,
                                 NEG_INF)
        cur = torch.logaddexp(from_blank, from_label)
        if d == 0:
            cur = torch.where((u_ar == 0).unsqueeze(0), 0.0, cur)
        alpha = torch.where(on.unsqueeze(0), cur, NEG_INF)
        diags.append(alpha)
    diags = torch.stack(diags)                        # (T + U, B, U + 1)
    tl = logit_lengths.long() - 1
    ul = label_lengths.long()
    bi = torch.arange(B, device=dev)
    loss = -(diags[tl + ul, bi, ul] + blank_lp[bi, tl, ul])
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def class_center_sample(label, num_classes, num_samples, group=None,
                        seed=None):
    """Sample ``num_samples`` class centres holding every positive class
    (all of them when there are that many positives): returns (the labels
    remapped into the sampled set, the sampled classes, sorted). The
    negatives are drawn on the host: from ``seed`` when given, else from
    a seed drawn from PyTorch's default CPU generator (so ``paddle.seed``
    repeats the sequence). One process (the JAX package's form)."""
    lbl = label.detach().cpu().numpy().astype(np.int64).reshape(-1)
    pos = np.unique(lbl)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, (), dtype=torch.int64))
        gen = np.random.default_rng([int(seed), len(pos), num_classes])
        rest = np.setdiff1d(np.arange(num_classes), pos)
        extra = gen.permutation(rest)[:num_samples - len(pos)]
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.from_numpy(remap[lbl]).to(label.device),
            torch.from_numpy(sampled).to(label.device))


# in-place activations: x itself, overwritten
def relu_(x, name=None):
    return x.relu_()


def elu_(x, alpha=1.0, name=None):
    return torch.nn.functional.elu_(x, alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(torch.softmax(x, axis))


def tanh_(x, name=None):
    return x.tanh_()
