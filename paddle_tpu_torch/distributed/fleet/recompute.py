"""Activation recompute — port of ``paddle_tpu/distributed/fleet/
recompute.py`` (``recompute``, ``:52``), of the JAX engine's remat
policies (``paddle_tpu/parallel/engine.py:376-405``) and of the model's
``checkpoint_name`` anchors (``paddle_tpu/models/llama.py``: ``qkv``
``:401-403``, ``attn_out`` ``:465``, ``mlp_out`` ``:744-749, 787``).

JAX recomputes under ``jax.checkpoint``; the port under non-reentrant
``torch.utils.checkpoint``:

* :func:`recompute` runs a function so that only its inputs are kept for
  the backward, which runs it again (the JAX package's eager replay).
* :func:`checkpoint_name` is the anchor a policy saves by name: an
  identity op registered with the dispatcher
  (``paddle_tpu_torch::checkpoint_name``), because a selective-checkpoint
  policy sees dispatcher ops only. A registered op may not return its
  input, so the anchor is a contiguous copy, made only for a name that
  the policy of the layer being run saves (``qkv`` at S = 16384 on
  Llama-3-8B's widths is 200 MB a layer, ``mlp_out`` 128 MB). Anywhere
  else (no remat, ``cfg.recompute``, ``"dots"``, ``"nothing"``, a name
  the policy does not save) ``checkpoint_name`` returns its input.
* :func:`remat_context_fn` turns a JAX policy name into the
  ``context_fn`` of a selective checkpoint
  (``create_selective_checkpoint_contexts``); None is full recompute.
* :func:`remat_layers` opens the engine's scope in which a model that
  checkpoints by layer (``LlamaModel``) runs each decoder layer through
  :func:`layer_checkpoint`'s function under that policy. The scope counts
  the layers so run, and the engine refuses a model that ran none.

What a policy can see: dispatcher ops. The kernels launch through ctypes
inside ``torch.autograd.Function``s, so no policy saves their outputs:
the flash forward runs again in the backward under every policy, as the
Pallas call does under every JAX policy (it is neither a dot nor named).
Nothing a kernel fills in place is ever saved: the policies save only
the outputs of ``aten.mm`` / ``aten.addmm`` and of the anchor, never an
``aten.empty``.

``remat_policy="offload_attn"`` (JAX: ``save_and_offload_only_these_
names``, nothing saved on the device, ``attn_out`` and ``mlp_out``
offloaded to pinned host memory): each layer is checkpointed saving only
its inputs, as under ``"nothing"``; in the layer's forward the two
anchors are copied to pinned host buffers, and in its recompute each is
brought back and used in place of its recomputed value, so the layer's
backward reads the host copies (the output projection's weight gradient
reads ``attn_out``). The recompute still runs what precedes an anchor,
the flash forward included, as it does under every policy. The host
buffers are preallocated, one an anchor of the step in the order the
step runs them (:class:`HostStash`, made at their first use, outside a
capture), so a CUDA graph replays the same copies; the engine opens the
stash's scope around each step. On CPU tensors "host" is where
they already are: the buffers are plain CPU tensors (outside an engine's
stash scope, a clone).

RNG preservation (``preserve_rng_state``): PyTorch's checkpoint stashes
the default generators' states with ``get_rng_state``, which a CUDA graph
capture refuses. Inside a :class:`RegionRng` scope, which the engine opens
around every train step on a CUDA device (eager or captured), a
checkpointed region instead draws from graph-safe generator states: the
k-th region of a step runs its forward on one clone of the default CUDA
generator and its recompute on a second clone made at the same point
(``graphsafe_set_state`` swaps them in), so the two draw the same numbers;
both are registered with each graph the engine captures, so that every
replay advances them as an eager step does. Outside such a scope (on the
CPU) PyTorch's own stash is kept.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: the JAX engine's policy names
REMAT_POLICIES = ("dots", "nothing", "save_attn", "save_attn_mlp",
                  "save_qkv_attn", "offload_attn")
#: checkpoint names each offloading policy keeps in pinned host memory
_OFFLOADED_NAMES = {"offload_attn": ("attn_out", "mlp_out")}
#: checkpoint names each named policy saves
_SAVED_NAMES = {"save_attn": ("attn_out",),
                "save_attn_mlp": ("attn_out", "mlp_out"),
                "save_qkv_attn": ("attn_out", "qkv")}
#: products of matrices without batch dims ("dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class RegionRng:
    """The graph-safe generator states of the checkpointed regions of a
    train step on one CUDA device: a pair of clones of the default
    generator a region, in the order the step runs its regions, made at
    their first use (an eager step: a capture follows a warm-up of the
    same step) and kept for every later step."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pairs = []
        self.next = 0

    def _default(self):
        idx = self.device.index
        return torch.cuda.default_generators[
            torch.cuda.current_device() if idx is None else idx]

    def take(self):
        """The (forward, recompute) generators of the step's next
        region."""
        k = self.next
        self.next += 1
        if k == len(self.pairs):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a checkpointed region ran in a CUDA "
                                   "graph capture but not in its warm-up")
            # a seed of its own a region: regions draw independent streams
            seed = (self._default().initial_seed() * 1000003 + k + 1) \
                % 2 ** 63
            self.pairs.append(tuple(
                torch.Generator(device=self.device).manual_seed(seed)
                for _ in range(2)))
        return self.pairs[k]

    def generators(self):
        """Every clone, for ``CUDAGraph.register_generator_state``."""
        return [g for pair in self.pairs for g in pair]

    @contextlib.contextmanager
    def drawing_from(self, gen):
        """Within: the default CUDA generator draws from ``gen``'s
        state."""
        default = self._default()
        main = default.graphsafe_get_state()
        default.graphsafe_set_state(gen)
        try:
            yield
        finally:
            default.graphsafe_set_state(main)


class HostStash:
    """The host copies of a train step's offloaded anchors: one buffer an
    anchor, in the order the step runs them, made at its first use (an
    eager step: a capture follows a warm-up of the same step) and kept for
    every later step, pinned in place when the anchor is on a CUDA device
    (``graphs.pinned_zeros``)."""

    def __init__(self):
        self.bufs = []
        self.next = 0

    def take(self, x):
        """The host buffer of the step's next anchor, shaped as ``x``."""
        k = self.next
        self.next += 1
        if k == len(self.bufs):
            if x.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("an offloaded anchor ran in a CUDA graph "
                                   "capture but not in its warm-up")
            from ...graphs import pinned_zeros

            self.bufs.append(pinned_zeros(x.shape, x.dtype) if x.is_cuda
                             else torch.empty(x.shape, dtype=x.dtype))
        buf = self.bufs[k]
        if buf.shape != x.shape or buf.dtype != x.dtype:
            raise RuntimeError(f"offloaded anchor {k} changed shape: "
                               f"{tuple(buf.shape)} {buf.dtype} -> "
                               f"{tuple(x.shape)} {x.dtype}")
        return buf

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.bufs)


_HOST_STASH = contextvars.ContextVar("paddle_tpu_torch_host_stash",
                                     default=None)


@contextlib.contextmanager
def host_stash(store: HostStash):
    """Within: offloaded anchors copy into ``store``'s buffers (numbered
    from 0 for this step)."""
    store.next = 0
    token = _HOST_STASH.set(store)
    try:
        yield store
    finally:
        _HOST_STASH.reset(token)


# the checkpointed layer being run: whether this run is its recompute, and
# the host buffers its forward filled, in order
_REGION = contextvars.ContextVar("paddle_tpu_torch_offload_region",
                                 default=None)


def _offload_anchor(x):
    """An offloaded anchor: in the layer's forward, ``x`` copied to the
    step's next host buffer (``x`` returned); in its recompute, that
    buffer brought back in place of the recomputed value (what the
    layer's backward then reads)."""
    region = _REGION.get()
    if not region["recomputing"]:
        store = _HOST_STASH.get()
        if store is not None:
            buf = store.take(x)
        elif x.is_cuda:
            raise RuntimeError("an offloaded anchor on a CUDA device needs "
                               "the engine's host stash (ParallelEngine, "
                               "remat_policy='offload_attn')")
        else:
            buf = torch.empty_like(x)
        buf.copy_(x.detach(), non_blocking=True)
        region["bufs"].append(buf)
        return x
    buf = region["bufs"][region["next"]]
    region["next"] += 1
    out = buf.to(x.device, non_blocking=True) if x.is_cuda else buf.clone()
    return out.requires_grad_(x.requires_grad)


_REGION_RNG = contextvars.ContextVar("paddle_tpu_torch_region_rng",
                                     default=None)


@contextlib.contextmanager
def region_rng(store: RegionRng):
    """Within: checkpointed regions preserve their draws through
    ``store``'s graph-safe states (numbered from 0 for this step)."""
    store.next = 0
    token = _REGION_RNG.set(store)
    try:
        yield store
    finally:
        _REGION_RNG.reset(token)


def _checkpoint(function, *args, preserve_rng_state=True, **kw):
    """Non-reentrant ``checkpoint`` of ``function(*args)`` whose
    recompute draws the random numbers its forward drew: PyTorch's stash,
    or inside a :func:`region_rng` scope the region's graph-safe pair."""
    store = _REGION_RNG.get()
    if store is None or not preserve_rng_state:
        return checkpoint(function, *args, use_reentrant=False,
                          preserve_rng_state=preserve_rng_state, **kw)
    runs = iter(store.take())

    def run(*a):
        # the forward on the first clone, the recompute on the second
        with store.drawing_from(next(runs)):
            return function(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def recompute(function, *args, **kwargs):
    """``function(*args)`` with its activations recomputed in the backward
    instead of kept: only ``args`` are saved. Keyword arguments:
    ``preserve_rng_state`` (default True: the replay draws the random
    numbers the forward drew) and ``use_reentrant`` (accepted, as in JAX,
    and ignored: the port always takes the non-reentrant form); any other
    raises ``ValueError``, as in JAX."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if kwargs:
        raise ValueError(f"unsupported kwargs {list(kwargs)}")
    return _checkpoint(function, *args, preserve_rng_state=bool(preserve))


@torch.library.custom_op("paddle_tpu_torch::checkpoint_name",
                         mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _checkpoint_name_backward(ctx, grad):
    return grad, None


_checkpoint_name.register_autograd(_checkpoint_name_backward)
_ANCHOR = torch.ops.paddle_tpu_torch.checkpoint_name.default


# the checkpoint names anchored in the layer being run: those its policy
# saves, and those it offloads (empty outside a checkpointed layer)
_ANCHORED = contextvars.ContextVar("paddle_tpu_torch_anchored",
                                   default=frozenset())
_OFFLOADED = contextvars.ContextVar("paddle_tpu_torch_offloaded",
                                    default=frozenset())


@contextlib.contextmanager
def anchored(names, offloaded=()):
    """Within: :func:`checkpoint_name` anchors the names in ``names`` and
    offloads those in ``offloaded``."""
    token = _ANCHORED.set(frozenset(names))
    token_off = _OFFLOADED.set(frozenset(offloaded))
    try:
        yield
    finally:
        _OFFLOADED.reset(token_off)
        _ANCHORED.reset(token)


def checkpoint_name(x, name: str):
    """``x`` under the checkpoint name ``name`` (``jax.ad_checkpoint.
    checkpoint_name``): the same values, as the anchor's contiguous copy
    where the policy of the layer being run saves ``name``, through a
    host copy where it offloads ``name``, else ``x`` itself."""
    if name in _OFFLOADED.get():
        return _offload_anchor(x)
    return _checkpoint_name(x, name) if name in _ANCHORED.get() else x


def _policy(saved_names, dots, ctx, op, *args, **kwargs):
    if op is _ANCHOR and args[1] in saved_names:
        return CheckpointPolicy.MUST_SAVE
    # a product autograd records: one of the differentiated graph's
    # activations (the fused CE's chunk logits, made inside its Function
    # without grad, stay its own business and are recomputed)
    if dots and op in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def check_remat_policy(policy):
    """Raise ValueError for an unknown policy name, as the JAX engine
    does."""
    if policy is not None and policy != "none" and \
            policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")


def remat_context_fn(policy):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for a
    JAX policy name: ``"dots"`` saves the outputs of ``aten.mm`` /
    ``aten.addmm`` (``dots_with_no_batch_dims_saveable``), the named
    policies the anchors they name (``save_only_these_names``); None for
    ``"nothing"``, ``"offload_attn"`` (whose anchors go to the host
    outside the policy), ``"none"`` and None, which save only the checkpoint's
    inputs (``nothing_saveable``, or no policy: the same in JAX)."""
    check_remat_policy(policy)
    dots = policy == "dots"
    names = _SAVED_NAMES.get(policy, ())
    if not dots and not names:
        return None
    fn = functools.partial(_policy, names, dots)
    return functools.partial(create_selective_checkpoint_contexts, fn)


class _LayerScope:
    """An open :func:`remat_layers` scope: the policy's ``context_fn``, the
    names it saves and the count of layers checkpointed under it."""

    def __init__(self, policy):
        self.context_fn = remat_context_fn(policy)
        self.names = frozenset(_SAVED_NAMES.get(policy, ()))
        self.offloaded = frozenset(_OFFLOADED_NAMES.get(policy, ()))
        self.layers = 0


_LAYER_REMAT = contextvars.ContextVar("paddle_tpu_torch_layer_remat",
                                      default=None)


@contextlib.contextmanager
def remat_layers(policy):
    """Within: :func:`layer_checkpoint` gives the function that runs one
    layer under ``policy``. Yields the scope, whose ``layers`` counts the
    layers run so."""
    scope = _LayerScope(policy)
    token = _LAYER_REMAT.set(scope)
    try:
        yield scope
    finally:
        _LAYER_REMAT.reset(token)


def _run_anchored(names, offloaded, region, layer, *args):
    # the checkpointed function: its replay in the backward anchors the
    # same names as the forward, on whatever thread runs it; every call
    # after the first is a recompute, which reads the forward's host
    # buffers from the first
    region["recomputing"] = region["runs"] > 0
    region["runs"] += 1
    region["next"] = 0
    token = _REGION.set(region)
    try:
        with anchored(names, offloaded):
            return layer(*args)
    finally:
        _REGION.reset(token)


def layer_checkpoint():
    """``run(layer, *args)``, checkpointing one layer under the policy of
    the innermost :func:`remat_layers` scope, while one is open and grad
    is on; None otherwise."""
    scope = _LAYER_REMAT.get()
    if scope is None or not torch.is_grad_enabled():
        return None
    kw = {} if scope.context_fn is None else dict(
        context_fn=scope.context_fn)

    def run(layer, *args):
        scope.layers += 1
        region = {"runs": 0, "recomputing": False, "bufs": [], "next": 0}
        return _checkpoint(functools.partial(
            _run_anchored, scope.names, scope.offloaded, region, layer),
            *args, **kw)

    return run
