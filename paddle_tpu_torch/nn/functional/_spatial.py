"""The argument forms the convolutions and the pools share: per-axis
tuples, the padding forms of the JAX package's ``_pad_spec`` with XLA's
``"SAME"`` / ``"VALID"`` rules, and the channel-first / channel-last
permutes."""
from __future__ import annotations

CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")


def tup(v, n):
    """An int, or a list of one or ``n`` ints, as ``n`` ints. The JAX
    package's pools cycle a list of another length (the port raises
    NotImplementedError) and its convolutions pass it on to XLA, which
    refuses it."""
    if not isinstance(v, (list, tuple)):
        return (int(v),) * n
    if len(v) == 1:
        return (int(v[0]),) * n
    if len(v) != n:
        raise NotImplementedError(
            f"{list(v)!r} for {n} spatial axes: a list of 1 or {n} is ported")
    return tuple(int(i) for i in v)


def pad_spec(padding, n):
    """``"SAME"`` / ``"VALID"``, or a list of n (low, high) pairs from an
    int, a list of 1 or n ints (symmetric), a flat list of 2·n ints (low
    and high of each axis in turn) or a list of n pairs."""
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f"{padding!r}")
        return p
    if isinstance(padding, (list, tuple)) and len(padding) == n and \
            isinstance(padding[0], (list, tuple)):
        return [(int(p[0]), int(p[1])) for p in padding]
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        if any(isinstance(p, (list, tuple)) for p in padding):
            raise NotImplementedError(
                f"padding {padding!r}: pairs for the batch and channel axes "
                f"are not ported (the JAX package takes n pairs)")
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [(i, i) for i in tup(padding, n)]


def same_pads(spatial, kernel, stride, dilation=None):
    """XLA's SAME padding: ceil(in / stride) outputs, the odd pad high."""
    pads = []
    for i, (size, k, s) in enumerate(zip(spatial, kernel, stride)):
        d = 1 if dilation is None else dilation[i]
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def is_channel_last(op, data_format, formats):
    """Whether ``data_format`` (one of ``formats``, else
    NotImplementedError) puts the channels last."""
    if data_format not in formats:
        raise NotImplementedError(f"{op} data_format {data_format!r} is "
                                  f"not ported (one of {formats})")
    return data_format in CHANNEL_LAST


def to_channel_first(x, n):
    return x.permute(0, n + 1, *range(1, n + 1))


def to_channel_last(x, n):
    return x.permute(0, *range(2, n + 2), 1)
