"""The data pipeline of the PyTorch port (``paddle_tpu_torch/io``:
the datasets, the samplers, collate, ``DataLoader`` and its worker pools,
bucketing, the native token reader; ``paddle_tpu_torch/reader`` and
``paddle.batch``) against the JAX package on the CPU.

Both packages draw from the same global streams (numpy's for the
samplers and ``random_split``, Python's for ``reader.shuffle``), so each
case seeds them alike before each package runs and holds the port's
output to the JAX package's exactly: indices, batches, dtypes and values
(every value here is data, copied or stacked, never computed). A batch of
the JAX package is a ``paddle_tpu.Tensor``, the port's a CPU
``torch.Tensor``.

The worker-pool datasets are the packages' own classes (picklable by
reference), so that a worker started by ``forkserver`` imports no test
module."""
import random

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.io import native as jnative
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.io import native as tnative
from torch_tensor_parity import host


def _plain(v):
    """A batch (tensors of either package, lists, tuples, dicts) as numpy
    in plain lists and dicts."""
    if isinstance(v, (list, tuple)):
        return [_plain(a) for a in v]
    if isinstance(v, dict):
        return {k: _plain(a) for k, a in v.items()}
    if isinstance(v, (torch.Tensor, jpaddle.Tensor)):
        return host(v)
    return v


def _same(j, t, what=""):
    """Equal structure, dtypes and values."""
    j, t = _plain(j), _plain(t)
    if isinstance(j, list):
        assert isinstance(t, list) and len(j) == len(t), (what, j, t)
        for a, b in zip(j, t):
            _same(a, b, what)
    elif isinstance(j, dict):
        assert isinstance(t, dict) and j.keys() == t.keys(), what
        for k in j:
            _same(j[k], t[k], what)
    elif isinstance(j, np.ndarray):
        assert isinstance(t, np.ndarray), (what, type(t))
        assert t.dtype == j.dtype, (what, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        assert j == t, (what, j, t)


def _both(make, seed=0):
    """``make(pkg)`` for the JAX package and the port, numpy's and Python's
    global generators seeded alike before each."""
    out = []
    for pkg in (jpaddle, tpaddle):
        np.random.seed(seed)
        random.seed(seed)
        out.append(make(pkg))
    return out


def _arrays(n=10):
    rng = np.random.RandomState(3)
    return [rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.int64)]


# ------------------------------------------------------------- datasets

DATASETS = {
    "tensor": lambda pkg: [pkg.io.TensorDataset(_arrays())[i]
                           for i in range(10)],
    "compose": lambda pkg: [pkg.io.ComposeDataset(
        [pkg.io.TensorDataset(_arrays()), pkg.io.TensorDataset(
            _arrays(7)[:1])])[i] for i in range(7)],
    "concat": lambda pkg: [pkg.io.ConcatDataset(
        [pkg.io.TensorDataset(_arrays(4)), pkg.io.TensorDataset(
            _arrays(6))])[i] for i in (0, 3, 4, 9, -1, -10)],
    "subset": lambda pkg: [pkg.io.Subset(pkg.io.TensorDataset(_arrays()),
                                         [7, 2, 2, 9])[i] for i in range(4)],
    "chain": lambda pkg: list(iter(pkg.io.ChainDataset(
        [[np.float32(1), np.float32(2)], iter([np.int64(3)])]))),
    "random_split": lambda pkg: [list(s.indices) for s in
                                 pkg.io.random_split(range(10), [3, 7])],
    "random_split_frac": lambda pkg: [
        [s[i] for i in range(len(s))]
        for s in pkg.io.random_split(list(range(11)), [0.3, 0.7])],
    "lengths": lambda pkg: [len(pkg.io.ConcatDataset(
        [range(3), range(5)])), len(pkg.io.ComposeDataset(
            [range(3), range(5)])), len(pkg.io.TensorDataset(_arrays()))],
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_match_jax(name):
    j, t = _both(DATASETS[name])
    _same(j, t, name)


def test_iterable_dataset_refuses_indexing_and_len():
    for pkg in (jpaddle, tpaddle):
        d = pkg.io.IterableDataset()
        with pytest.raises(RuntimeError):
            d[0]
        with pytest.raises(RuntimeError):
            len(d)
        with pytest.raises(NotImplementedError):
            pkg.io.Dataset()[0]


# ------------------------------------------------------------- samplers

SAMPLERS = {
    "sequence": lambda pkg: list(pkg.io.SequenceSampler(range(7))),
    "random": lambda pkg: [list(pkg.io.RandomSampler(range(9)))
                           for _ in range(2)],
    "random_replacement": lambda pkg: list(pkg.io.RandomSampler(
        range(9), replacement=True, num_samples=12)),
    "random_num_samples": lambda pkg: list(pkg.io.RandomSampler(
        range(9), num_samples=4)),
    "weighted": lambda pkg: list(pkg.io.WeightedRandomSampler(
        [0.1, 0.5, 0.2, 0.2], 10)),
    "weighted_no_replacement": lambda pkg: list(pkg.io.WeightedRandomSampler(
        [0.1, 0.5, 0.2, 0.2], 3, replacement=False)),
    "batch": lambda pkg: list(pkg.io.BatchSampler(range(10), batch_size=3)),
    "batch_shuffle_drop": lambda pkg: [
        list(pkg.io.BatchSampler(range(10), shuffle=True, batch_size=3,
                                 drop_last=True)),
        len(pkg.io.BatchSampler(range(10), batch_size=3, drop_last=True)),
        len(pkg.io.BatchSampler(range(10), batch_size=3))],
    "batch_of_sampler": lambda pkg: list(pkg.io.BatchSampler(
        sampler=pkg.io.RandomSampler(range(8)), batch_size=3)),
    "distributed": lambda pkg: [
        list(pkg.io.DistributedBatchSampler(range(11), 2, num_replicas=3,
                                            rank=r)) for r in range(3)],
    "distributed_shuffle_epoch": lambda pkg: [
        (s.set_epoch(e), list(s), len(s))[1:]
        for s in [pkg.io.DistributedBatchSampler(
            range(13), 3, num_replicas=2, rank=1, shuffle=True,
            drop_last=True)] for e in (0, 0, 5)],
    "distributed_one_process": lambda pkg: list(
        pkg.io.DistributedBatchSampler(range(5), 2)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_match_jax(name, monkeypatch):
    # one process: the JAX package reads the launcher's variables
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    j, t = _both(SAMPLERS[name], seed=11)
    _same(j, t, name)


# ------------------------------------------------------------- collate

COLLATE = {
    "arrays": [np.arange(3, dtype=np.float32) + i for i in range(4)],
    "ints": [1, 2, 3],
    "floats": [1.5, 2.0],
    "strings": ["a", "b"],
    "dict": [{"x": np.ones(2, np.int32) * i, "s": "t"} for i in range(3)],
    "tuples": [(np.full((2, 2), i, np.float32), np.int64(i)) for i in
               range(3)],
    "nested": [([np.zeros(1, np.int64)], {"y": 1.0}) for _ in range(2)],
    "scalars": [np.float32(i) for i in range(3)],
}


@pytest.mark.parametrize("name", sorted(COLLATE))
def test_default_collate_matches_jax(name):
    batch = COLLATE[name]
    j = jpaddle.io.default_collate_fn(batch)
    t = tpaddle.io.default_collate_fn(batch)
    _same(j, t, name)
    for leaf in _leaves(t):
        assert not isinstance(leaf, torch.Tensor) or leaf.device.type == "cpu"


def _leaves(v):
    if isinstance(v, (list, tuple)):
        return [x for a in v for x in _leaves(a)]
    if isinstance(v, dict):
        return [x for a in v.values() for x in _leaves(a)]
    return [v]


def test_collate_of_tensors_and_convert_match_jax():
    j = jpaddle.io.default_collate_fn([jpaddle.to_tensor(
        np.ones(2, np.float32) * i) for i in range(3)])
    t = tpaddle.io.default_collate_fn([torch.ones(2) * i for i in range(3)])
    _same(j, t)
    sample = [np.arange(4).reshape(2, 2), ("s", np.float32(1.0))]
    _same(jpaddle.io.default_convert_fn(sample),
          tpaddle.io.default_convert_fn(sample))


# ------------------------------------------------------------- DataLoader

class _Stream(tpaddle.io.IterableDataset):
    """Defined here: iterated in this process only (no workers)."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter([np.full(2, i, np.float32) for i in range(self.n)])


class _JStream(jpaddle.io.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter([np.full(2, i, np.float32) for i in range(self.n)])


LOADERS = {
    "batches": lambda pkg: list(pkg.io.DataLoader(
        pkg.io.TensorDataset(_arrays()), batch_size=4)),
    "shuffle_drop_last": lambda pkg: list(pkg.io.DataLoader(
        pkg.io.TensorDataset(_arrays()), batch_size=4, shuffle=True,
        drop_last=True)),
    "no_batching": lambda pkg: list(pkg.io.DataLoader(
        pkg.io.TensorDataset(_arrays(3)), batch_size=None)),
    "batch_sampler": lambda pkg: list(pkg.io.DataLoader(
        pkg.io.TensorDataset(_arrays()),
        batch_sampler=pkg.io.DistributedBatchSampler(
            range(10), 3, num_replicas=2, rank=0, shuffle=True))),
    "collate_fn": lambda pkg: list(pkg.io.DataLoader(
        list(range(6)), batch_size=4, collate_fn=lambda b: sum(b))),
    "iterable": lambda pkg: list(pkg.io.DataLoader(
        (_JStream if pkg is jpaddle else _Stream)(7), batch_size=3)),
    "iterable_drop_last": lambda pkg: list(pkg.io.DataLoader(
        (_JStream if pkg is jpaddle else _Stream)(7), batch_size=3,
        drop_last=True)),
    "iterable_unbatched": lambda pkg: list(pkg.io.DataLoader(
        (_JStream if pkg is jpaddle else _Stream)(2), batch_size=None)),
    "lengths": lambda pkg: [len(pkg.io.DataLoader(range(10), batch_size=4)),
                            len(pkg.io.DataLoader(range(10), batch_size=4,
                                                  drop_last=True)),
                            len(pkg.io.DataLoader(range(10),
                                                  batch_size=None))],
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_single_process_loader_matches_jax(name):
    j, t = _both(LOADERS[name], seed=5)
    _same(j, t, name)


def test_loader_of_an_iterable_dataset_has_no_len():
    with pytest.raises(TypeError):
        len(tpaddle.io.DataLoader(_Stream(3), batch_size=2))
    assert tpaddle.io.get_worker_info() is None


def _big(n=24):
    """Samples of 80 KB (the shared-memory path) and small labels."""
    rng = np.random.RandomState(1)
    return [rng.randn(n, 10240).astype(np.float64),
            np.arange(n, dtype=np.int64)]


def test_map_pool_two_workers_match_one_process_and_jax():
    """The map pool (index queue in, shared memory out): batches in the
    sampler's order, equal to the port's single-process loader and to the
    JAX package's, shuffled from the same seed (the JAX package holds its
    own two workers to its single process)."""
    def load(pkg, workers):
        return list(pkg.io.DataLoader(pkg.io.TensorDataset(_big()),
                                      batch_size=5, shuffle=True,
                                      num_workers=workers))

    np.random.seed(9)
    j0 = load(jpaddle, 0)
    np.random.seed(9)
    t0 = load(tpaddle, 0)
    np.random.seed(9)
    t2 = load(tpaddle, 2)
    _same(j0, t2, "two workers")
    _same(t0, t2, "one process")
    assert len(t2) == 5 and all(b[0].device.type == "cpu" for b in t2)


def test_iterable_pool_two_workers_match_jax():
    """The iterable pool: each worker iterates its own replica of the
    dataset (here both yield every sample) and batches come round-robin
    by worker: the JAX package's single-process batches, each twice."""
    data = [np.full(3, i, np.int64) for i in range(7)]
    j = list(jpaddle.io.DataLoader(jpaddle.io.ChainDataset([data]),
                                   batch_size=2))
    t = list(tpaddle.io.DataLoader(tpaddle.io.ChainDataset([data]),
                                   batch_size=2, num_workers=2))
    _same([b for b in j for _ in range(2)], t)


def test_thread_prefetch_matches_the_worker_batches(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATALOADER_THREAD", "1")
    j, t = _both(LOADERS["shuffle_drop_last"], seed=2)
    np.random.seed(2)
    t1 = list(tpaddle.io.DataLoader(tpaddle.io.TensorDataset(_arrays()),
                                    batch_size=4, shuffle=True,
                                    drop_last=True, num_workers=2))
    _same(j, t)
    _same(t, t1)


# ------------------------------------------------------------- bucketing

def test_bucketing_matches_jax():
    for args in ((2048,), (300, 16, 1.5), (64, 64)):
        assert tpaddle.io.bucket_boundaries(*args) == \
            jpaddle.io.bucket_boundaries(*args)
    for bad in ((100, 32, 1.0), (10, 32)):
        for pkg in (jpaddle, tpaddle):
            with pytest.raises(ValueError):
                pkg.io.bucket_boundaries(*bad)
    ids = np.arange(2 * 37, dtype=np.int64).reshape(2, 37)
    buckets = tpaddle.io.bucket_boundaries(128)
    for wrap in (np.asarray, jpaddle.to_tensor):
        j = jpaddle.io.pad_to_bucket(wrap(ids), buckets, pad_value=7,
                                     labels=wrap(ids + 1))
        twrap = torch.from_numpy if wrap is not np.asarray else np.asarray
        t = tpaddle.io.pad_to_bucket(twrap(ids), buckets, pad_value=7,
                                     labels=twrap(ids + 1))
        _same(list(j), list(t))
        assert isinstance(t[0], torch.Tensor) == (wrap is not np.asarray)
    lengths = np.random.RandomState(0).randint(1, 200, 40)
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=3),
               dict(drop_last=True), dict(num_replicas=2, rank=1)):
        js = jpaddle.io.LengthBucketBatchSampler(lengths, 4, **kw)
        ts = tpaddle.io.LengthBucketBatchSampler(lengths, 4, **kw)
        for e in (0, 1):
            js.set_epoch(e)
            ts.set_epoch(e)
            assert list(ts) == list(js) and len(ts) == len(js), kw


# ------------------------------------------------------------- token reader

@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens.bin")
    tokens = np.random.RandomState(0).randint(0, 50000, 40 * 33)
    tnative.write_token_file(tokens, path)
    return path, tokens


def _batches(loader, n):
    out = [loader.next() for _ in range(n)]
    loader.close()
    return out


def test_native_token_reader_matches_jax(token_file):
    """The C++ reader (one thread: one draw order a seed) built by each
    package from the same source: the same windows in the same order,
    each row a window of the file with its next-token labels."""
    path, tokens = token_file
    j = jnative.TokenDataLoader(path, 32, 4, num_threads=1, seed=3,
                                shard_id=1, num_shards=2)
    assert j.native, "the JAX package's reader fell back to numpy"
    t = tnative.TokenDataLoader(path, 32, 4, num_threads=1, seed=3,
                                shard_id=1, num_shards=2)
    assert t.native and t.samples_per_shard() == j.samples_per_shard() == 20
    jb, tb = _batches(j, 5), _batches(t, 5)
    _same(jb, tb)
    windows = tokens.reshape(40, 33)
    for ids, labels in tb:
        assert ids.dtype == np.int32 and labels.dtype == np.int64
        np.testing.assert_array_equal(ids[:, 1:], labels[:, :-1])
        for row, lab in zip(ids, labels):
            s = [k for k in range(20, 40) if (windows[k, :-1] == row).all()]
            assert len(s) == 1 and (windows[s[0], 1:] == lab).all()


def test_numpy_token_reader_matches_jax(token_file, monkeypatch):
    """The plain version: the JAX package's numpy path (forced by
    refusing its library) against the port's ``native=False``."""
    path, _ = token_file
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    j = jnative.TokenDataLoader(path, 16, 3, seed=7)
    t = tnative.TokenDataLoader(path, 16, 3, seed=7, native=False)
    assert not j.native and not t.native
    assert t.samples_per_shard() == j.samples_per_shard()
    _same(_batches(j, 4), _batches(t, 4))


def test_token_reader_raises_instead_of_falling_back(token_file, tmp_path,
                                                     monkeypatch):
    path, _ = token_file
    with pytest.raises(ValueError, match="cannot read"):
        tnative.TokenDataLoader(path, 4096, 2)          # no whole window
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="missing"):
        tnative.TokenDataLoader(path, 16, 2)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="could not build"):
        tnative.TokenDataLoader(path, 16, 2)


def test_token_library_builds_into_the_ignored_build_dir():
    from paddle_tpu_torch.ops._build import BUILD_DIR

    lib = tnative._build_lib()
    assert lib.startswith(str(BUILD_DIR)) and "libptio-" in lib


# ------------------------------------------------------------- readers

def _r(n):
    return lambda: iter(range(n))


READERS = {
    "batch": lambda pkg: list(pkg.batch(_r(7), 3)()),
    "batch_drop_last": lambda pkg: list(pkg.batch(_r(7), 3, True)()),
    "cache": lambda pkg: list(pkg.reader.cache(_r(4))()),
    "map": lambda pkg: list(pkg.reader.map_readers(
        lambda a, b: a * 10 + b, _r(3), _r(4))()),
    "shuffle": lambda pkg: list(pkg.reader.shuffle(_r(11), 4)()),
    "chain": lambda pkg: list(pkg.reader.chain(_r(2), _r(3))()),
    "compose": lambda pkg: list(pkg.reader.compose(
        _r(3), lambda: iter([(7, 8)] * 3))()),
    "compose_unaligned": lambda pkg: list(pkg.reader.compose(
        _r(2), _r(3), check_alignment=False)()),
    "buffered": lambda pkg: list(pkg.reader.buffered(_r(9), 2)()),
    "firstn": lambda pkg: list(pkg.reader.firstn(_r(9), 4)()),
    "xmap_ordered": lambda pkg: list(pkg.reader.xmap_readers(
        lambda v: v * v, _r(12), 3, 4, order=True)()),
    "xmap": lambda pkg: sorted(pkg.reader.xmap_readers(
        lambda v: v + 1, _r(12), 3, 4)()),
    "multiprocess": lambda pkg: sorted(pkg.reader.multiprocess_reader(
        [_r(3), _r(4)])()),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_match_jax(name):
    j, t = _both(READERS[name], seed=4)
    assert t == j, name


def test_reader_refusals_match_jax():
    for pkg in (jpaddle, tpaddle):
        with pytest.raises(pkg.reader.ComposeNotAligned):
            list(pkg.reader.compose(_r(2), _r(3))())
        with pytest.raises(ValueError):
            pkg.batch(_r(2), 0)
        with pytest.raises(ValueError):
            pkg.reader.multiprocess_reader([])
