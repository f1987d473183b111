"""Optimizers — port of ``paddle_tpu/optimizer/optimizer.py`` (the
``Optimizer`` base, ``Adam`` and ``AdamW``).

State is kept per parameter NAME: ``{name: {"moment1", "moment2"[,
"master_weight"]}}``, fp32, created at the first update (or by
:meth:`Optimizer.init_state`). :meth:`Optimizer.update` is the counterpart
of the JAX package's ``pure_update``: clip the grads, then one per-tensor
update through ``ops.fused_adamw.fused_adamw_update`` with the bias
correction at ``step``. Unlike the pure JAX function it updates the
parameters and the moments IN PLACE, which saves a copy of the state.
:meth:`Optimizer.step` is the eager API: it reads ``param.grad`` and
counts its own steps.
"""
from __future__ import annotations

from typing import Dict

import torch

from .lr import LRScheduler


def _named(parameters):
    """[(name, param)] from an iterable of parameters or of (name, param)
    pairs (``model.named_parameters()``); unnamed ones get ``param_{i}``."""
    out = []
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            out.append(item)
        else:
            out.append((getattr(item, "name", None) or f"param_{i}", item))
    return out


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = (_named(parameters) if parameters is not None
                                else None)
        self._grad_clip = grad_clip
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "regularizer objects as weight_decay are not ported yet; "
                "pass a float (L2 coefficient)")
        self._l2_coeff = float(weight_decay or 0.0)
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    # ----------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    # --------------------------------------------------------------- state
    def _create_slots(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, named_params) -> None:
        """Create the slots of every (name, param) now, so that the state
        exists before the first step (``ParallelEngine`` does this)."""
        for name, p in named_params:
            self._slots_for(name, p)

    def _slots_for(self, name, p) -> Dict[str, torch.Tensor]:
        if name not in self._accumulators:
            with torch.no_grad():
                self._accumulators[name] = self._create_slots(p)
        return self._accumulators[name]

    # ---------------------------------------------------------------- step
    def step(self):
        """Eager step over the optimizer's own parameters' ``.grad``."""
        if self._parameter_list is None:
            raise ValueError("Optimizer created without explicit parameters; "
                             "pass parameters=model.named_parameters()")
        self._global_step += 1
        self.update([(n, p, p.grad) for n, p in self._parameter_list
                     if p.grad is not None], self.get_lr(), self._global_step)

    def update(self, named_params_grads, lr, step):
        """One optimizer step over ``[(name, param, grad)]``: clip, then
        each parameter's update rule, in place, with bias correction at
        ``step`` (1 for the first update)."""
        if self._grad_clip is not None:
            self._grad_clip([(p, g) for _, p, g in named_params_grads])
        with torch.no_grad():
            for name, p, g in named_params_grads:
                self._apply_one(name, p, g, lr, step,
                                self._slots_for(name, p))

    def clear_grad(self):
        for _, p in self._parameter_list or ():
            p.grad = None

    def _apply_one(self, name, param, grad, lr, step, slots):
        raise NotImplementedError


class Adam(Optimizer):
    """Adam; a float ``weight_decay`` is L2 folded into the gradient (the
    Paddle semantics the JAX package keeps). ``multi_precision`` keeps an
    fp32 ``master_weight`` for every non-fp32 parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            raise NotImplementedError("lazy_mode is not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _create_slots(self, p):
        slots = {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device),
                 "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}
        if self._multi_precision and p.dtype != torch.float32:
            slots["master_weight"] = p.detach().float()
        return slots

    def _decay(self, name) -> float:
        return 0.0

    def _apply_one(self, name, param, grad, lr, step, slots):
        from ..ops.fused_adamw import fused_adamw_update

        if self._l2_coeff:
            grad = grad.float() + self._l2_coeff * param.float()
        fused_adamw_update(param.data, grad, slots["moment1"],
                           slots["moment2"], lr=lr, step=step,
                           b1=self._beta1, b2=self._beta2, eps=self._epsilon,
                           decay=self._decay(name),
                           master=slots.get("master_weight"))


class AdamW(Adam):
    """Decoupled weight decay: ``weight_decay`` (0.01 unless a float is
    given, as in the JAX package) scales the master weight by
    ``1 - lr·decay`` before the moment update, for every parameter whose
    name ``apply_decay_param_fun`` accepts (all when it is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd_coeff = (float(weight_decay)
                          if isinstance(weight_decay, (int, float)) else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay(self, name) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd_coeff
