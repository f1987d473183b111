"""Automatic mixed precision — port of ``paddle_tpu/amp/__init__.py``
(``auto_cast`` / ``amp_guard``, ``decorate``, ``GradScaler`` /
``AmpScaler``).

bf16 first, as the JAX package. O1 casts the floating inputs of the ops on
the white list to the AMP dtype; O2 casts those of every op not on the
black list (``custom_white_list`` / ``custom_black_list`` extend the
lists). The JAX package applies the rule in its dispatcher, to every op;
the port applies it where its functional ops stand in for that dispatcher
(:func:`cast_inputs`): ``linear`` (``nn.functional.linear`` and the Llama
projections), ``matmul``, ``einsum`` (Llama's masked attention), ``sdpa``
(``nn.functional.scaled_dot_product_attention``), ``flash_attention`` and
``conv1d`` / ``conv2d`` / ``conv3d`` (``nn.functional.conv*d``).
The norms and losses are on the black list, which casts nothing, so they
run in their inputs' dtype as in JAX. ``decorate(level="O2")`` casts the
models' floating parameters and buffers (in place: the optimizer's
parameters stay the same objects) and sets the optimizers'
``multi_precision`` (fp32 master weights).

:class:`GradScaler` scales the loss and, in :meth:`GradScaler.step`,
unscales the gradients into fp32 and skips the optimizer's step when any
is not finite, as the JAX ``AmpScaler``: the check is one device
reduction and one host read (JAX reads each gradient's flag). The fp32
unscaled gradients go straight to the optimizer's eager update (a bf16
parameter's ``.grad`` keeps its dtype, as PyTorch requires).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["AmpScaler", "BLACK_LIST", "GradScaler", "WHITE_LIST",
           "amp_dtype", "amp_guard", "amp_state", "auto_cast",
           "cast_inputs", "decorate", "should_cast_to_low_precision"]

WHITE_LIST = {"matmul", "conv2d", "conv1d", "conv3d", "einsum", "linear",
              "bmm", "mm", "flash_attention", "sdpa"}
BLACK_LIST = {"exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
              "softmax_with_cross_entropy",
              "sigmoid_cross_entropy_with_logits", "cross_entropy",
              "c_softmax_with_cross_entropy", "layer_norm", "group_norm",
              "rms_norm", "reduce_sum", "log_softmax"}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"amp dtype must be one of {tuple(_DTYPES)}, got "
                         f"{d!r}")
    return _DTYPES[d]


class _AmpState(threading.local):
    def __init__(self):
        self.level = "O0"
        self.dtype = torch.bfloat16
        self.custom_white = set()
        self.custom_black = set()


_amp_state = _AmpState()


def amp_state():
    return _amp_state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: within, :func:`cast_inputs` applies the
    ``level``'s rule (``"O0"``, or ``enable=False``, casts nothing)."""
    prev = (_amp_state.level, _amp_state.dtype, _amp_state.custom_white,
            _amp_state.custom_black)
    _amp_state.level = level if enable else "O0"
    _amp_state.dtype = _dtype(dtype)
    _amp_state.custom_white = set(custom_white_list or [])
    _amp_state.custom_black = set(custom_black_list or [])
    try:
        yield
    finally:
        (_amp_state.level, _amp_state.dtype, _amp_state.custom_white,
         _amp_state.custom_black) = prev


amp_guard = auto_cast


def should_cast_to_low_precision(op_name: str) -> bool:
    if _amp_state.level == "O0":
        return False
    if op_name in _amp_state.custom_black or op_name in BLACK_LIST:
        return False
    if _amp_state.level == "O2":
        return True
    return op_name in WHITE_LIST or op_name in _amp_state.custom_white


def amp_dtype() -> torch.dtype:
    return _amp_state.dtype


def cast_inputs(op_name: str, *tensors):
    """``tensors`` as op ``op_name`` takes them under the current AMP
    state: the floating ones cast to the AMP dtype where
    :func:`should_cast_to_low_precision`, else unchanged (None passes)."""
    if _amp_state.level == "O0" or not should_cast_to_low_precision(op_name):
        return tensors
    tgt = _amp_state.dtype
    return tuple(t.to(tgt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != tgt else t
                 for t in tensors)


@torch.no_grad()
def _convert_dtype(module, dtype) -> None:
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    for b in module.buffers():
        if b.is_floating_point():
            b.data = b.data.to(dtype)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: O2 casts the models' floating parameters
    and buffers to ``dtype`` and sets every optimizer's
    ``multi_precision`` (fp32 master weights); O1 changes nothing. Returns
    the models (and the optimizers when given)."""
    d = _dtype(dtype)
    models_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in models_list:
            _convert_dtype(m, d)
            m._casted_by_pure_fp16 = True
        if optimizers is not None:
            opts = optimizers if isinstance(optimizers, (list, tuple)) \
                else [optimizers]
            for o in opts:
                if hasattr(o, "_multi_precision"):
                    o._multi_precision = True
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (``paddle.amp.GradScaler`` / ``AmpScaler``)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = None

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """The optimizer's trainable gradients times 1/scale, in fp32 (kept
        for :meth:`step`); ``found_inf`` from one reduction over all of
        them and one host read."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        named = optimizer._eager_params_grads()
        self._unscaled = [(n, p, g.float() * inv) for n, p, g in named]
        if not named:
            self._found_inf = False
            return
        finite = torch.stack([torch.isfinite(g).all()
                              for _, _, g in self._unscaled]).all()
        self._found_inf = not bool(finite)

    def minimize(self, optimizer, loss):
        loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer._eager_update(self._unscaled)
        self._unscaled = None

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state_dict):
        self._scale = state_dict.get("scale", self._scale)
        self._good_steps = state_dict.get("incr_count", 0)
        self._bad_steps = state_dict.get("decr_count", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
