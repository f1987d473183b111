"""Optimizers — port of ``paddle_tpu/optimizer/optimizer.py`` (the
``Optimizer`` base and SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
RMSProp, Adadelta, Lamb and Lars), with the JAX package's slot names and
update rules.

State is kept per parameter NAME: ``{name: {slot: tensor}}``, fp32,
created at the first update (or by :meth:`Optimizer.init_state`).
:meth:`Optimizer.update` is the counterpart of the JAX package's
``pure_update``: clip the grads, fold a float ``weight_decay`` into them
(L2, every optimizer but AdamW and Lamb), then each parameter's update
rule. The learning rate and the step count (1 for the first update) come
as 0-d device tensors, as the JAX engine traces them, so no host value
enters the update and a CUDA graph can replay it while they change.
Unlike the pure JAX function it updates the parameters and the slots IN
PLACE, which saves a copy of the state. Adam and AdamW run the fused
AdamW kernel (``ops/fused_adamw.py``) with the step's ``[lr, 1/bc1,
1/bc2]`` built once on the device; the others are plain PyTorch on fp32
(the JAX package has no kernel for them), and only Adam and AdamW keep an
fp32 ``master_weight`` (``multi_precision``), as in JAX. Lamb's and
Lars's trust ratios take the device ``torch.where`` of JAX's
``jnp.where``. :meth:`Optimizer.step` is the eager API: it reads
``param.grad`` and counts its own steps.

Not ported (NotImplementedError): regularizer objects as
``weight_decay``, Adam's ``lazy_mode``, AdamW's ``lr_ratio``, the
multi-tensor ``PT_MT_ADAMW`` state (``flat_adamw_update``), Lamb's
``exclude_from_weight_decay_fn`` and Lars's ``exclude_from_weight_decay``
(accepted and ignored by the JAX package, whose numbers the port keeps).
"""
from __future__ import annotations

import os
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


def _unported(value, what):
    if value is not None and value is not False:
        raise NotImplementedError(f"{what} is not ported yet")


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
        # fp32 constants on each device, made at the first (eager) update:
        # a graph reads them by address
        self._consts: Dict[tuple, torch.Tensor] = {}
        self._step_scalars = None

    # ----------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    # --------------------------------------------------------------- state
    def _create_slots(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _zeros(self, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

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

    def _const(self, values, device) -> torch.Tensor:
        """The fp32 tensor of ``values`` (a tuple) on ``device``, made once."""
        key = (tuple(values), str(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.tensor(values, dtype=torch.float32,
                                                 device=device)
        return t

    def _pow(self, beta, step):
        """``beta ** step`` in fp32 on the device, JAX's traced arithmetic
        (the step converted to fp32)."""
        return torch.pow(self._const((beta,), step.device)[0],
                         step.to(torch.float32))

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
        each parameter's update rule, in place. ``lr`` (fp32) and ``step``
        (an integer, 1 for the first update) are 0-d tensors on the
        parameters' device; numbers are put there first."""
        if not named_params_grads:
            return
        dev = named_params_grads[0][1].device
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        step = torch.as_tensor(step, dtype=torch.int32, device=dev)
        if self._grad_clip is not None:
            self._grad_clip([(p, g) for _, p, g in named_params_grads])
        with torch.no_grad():
            # per-step values every parameter reads; dropped after the
            # step, so that none outlives a graph's capture
            self._step_scalars = self._begin(lr, step)
            try:
                for name, p, g in named_params_grads:
                    self._apply_one(name, p, g, lr, step,
                                    self._slots_for(name, p))
            finally:
                self._step_scalars = None

    def _begin(self, lr, step):
        """Per-step work shared by every parameter (Adam's scalars)."""
        return None

    def _grad32(self, param, grad):
        """The gradient in fp32, with a float ``weight_decay`` folded in as
        L2 (``pure_update``), where the optimizer takes it."""
        g = grad.float()
        if self._l2_coeff:
            g = g + self._l2_coeff * param.float()
        return g

    def clear_grad(self):
        for _, p in self._parameter_list or ():
            p.grad = None

    def _apply_one(self, name, param, grad, lr, step, slots):
        raise NotImplementedError


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _apply_one(self, name, param, grad, lr, step, slots):
        param.copy_(param.float() - lr * self._grad32(param, grad))


class Momentum(Optimizer):
    """Heavy-ball (or Nesterov) momentum, slot ``velocity``;
    ``multi_precision`` is accepted and, as in the JAX package, keeps no
    master weight."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_slots(self, p):
        return {"velocity": self._zeros(p)}

    def _apply_one(self, name, param, grad, lr, step, slots):
        g = self._grad32(param, grad)
        vel = slots["velocity"]
        vel.copy_(vel * self._momentum + g)
        upd = g + self._momentum * vel if self._nesterov else vel
        param.copy_(param.float() - lr * upd)


class Adam(Optimizer):
    """Adam; a float ``weight_decay`` is L2 folded into the gradient (the
    Paddle semantics the JAX package keeps). ``multi_precision`` keeps an
    fp32 ``master_weight`` for every non-fp32 parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        _unported(lazy_mode, "lazy_mode")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _create_slots(self, p):
        slots = {"moment1": self._zeros(p), "moment2": self._zeros(p)}
        if self._multi_precision and p.dtype != torch.float32:
            slots["master_weight"] = p.detach().float()
        return slots

    def _decay(self, name) -> float:
        return 0.0

    def _begin(self, lr, step):
        from ..ops.fused_adamw import adamw_scalars

        # [lr, 1/bc1, 1/bc2] once a step, read by every launch
        return adamw_scalars(
            lr, step, self._const((self._beta1, self._beta2), lr.device))

    def _apply_one(self, name, param, grad, lr, step, slots):
        from ..ops.fused_adamw import fused_adamw_update

        if self._l2_coeff:
            grad = self._grad32(param, grad)
        fused_adamw_update(param.data, grad, slots["moment1"],
                           slots["moment2"], scalars=self._step_scalars,
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
        _unported(lr_ratio, "lr_ratio")
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

    def init_state(self, named_params) -> None:
        named_params = list(named_params)
        # where JAX would take its flat multi-tensor state (_mt_active)
        if os.environ.get("PT_MT_ADAMW") == "1" and \
                self._apply_decay_param_fun is None and \
                not self._multi_precision and len(named_params) >= 2 and \
                len({p.dtype for _, p in named_params}) == 1:
            raise NotImplementedError(
                "the multi-tensor flat AdamW state (PT_MT_ADAMW=1, "
                "flat_adamw_update) is not ported yet")
        super().init_state(named_params)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_slots(self, p):
        return {"moment": self._zeros(p), "inf_norm": self._zeros(p)}

    def _apply_one(self, name, param, grad, lr, step, slots):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g = self._grad32(param, grad)
        m, u = slots["moment"], slots["inf_norm"]
        m.copy_(b1 * m + (1 - b1) * g)
        u.copy_(torch.maximum(b2 * u, g.abs()))
        upd = lr / (1 - self._pow(b1, step)) * m / (u + eps)
        param.copy_(param.float() - upd)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_slots(self, p):
        return {"moment": torch.full(p.shape, float(self._init_acc),
                                     dtype=torch.float32, device=p.device)}

    def _apply_one(self, name, param, grad, lr, step, slots):
        g = self._grad32(param, grad)
        acc = slots["moment"]
        acc.copy_(acc + g * g)
        param.copy_(param.float()
                    - lr * g / (torch.sqrt(acc) + self._epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_slots(self, p):
        s = {"mean_square": self._zeros(p), "momentum_acc": self._zeros(p)}
        if self._centered:
            s["mean_grad"] = self._zeros(p)
        return s

    def _apply_one(self, name, param, grad, lr, step, slots):
        rho, eps = self._rho, self._epsilon
        g = self._grad32(param, grad)
        ms = slots["mean_square"]
        ms.copy_(rho * ms + (1 - rho) * g * g)
        if self._centered:
            mg = slots["mean_grad"]
            mg.copy_(rho * mg + (1 - rho) * g)
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom = slots["momentum_acc"]
        mom.copy_(self._momentum * mom + lr * g / denom)
        param.copy_(param.float() - mom)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _create_slots(self, p):
        return {"avg_squared_grad": self._zeros(p),
                "avg_squared_update": self._zeros(p)}

    def _apply_one(self, name, param, grad, lr, step, slots):
        rho, eps = self._rho, self._epsilon
        g = self._grad32(param, grad)
        g2, u2 = slots["avg_squared_grad"], slots["avg_squared_update"]
        g2.copy_(rho * g2 + (1 - rho) * g * g)
        upd = g * torch.sqrt(u2 + eps) / torch.sqrt(g2 + eps)
        u2.copy_(rho * u2 + (1 - rho) * upd * upd)
        param.copy_(param.float() - lr * upd)


def _norm(t):
    return torch.sqrt(torch.sum(t * t))


class Lamb(Optimizer):
    """LAMB: Adam's moments with the bias corrections at ``step``, the
    update ``r`` with ``lamb_weight_decay`` times the weight, scaled by the
    trust ratio ``|w| / |r|`` (1 where either norm is 0)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        _unported(exclude_from_weight_decay_fn,
                  "Lamb exclude_from_weight_decay_fn")
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay

    def _create_slots(self, p):
        return {"moment1": self._zeros(p), "moment2": self._zeros(p)}

    def _apply_one(self, name, param, grad, lr, step, slots):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g = self._grad32(param, grad)
        m, v = slots["moment1"], slots["moment2"]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        mhat = m / (1 - self._pow(b1, step))
        vhat = v / (1 - self._pow(b2, step))
        p32 = param.float()
        r = mhat / (torch.sqrt(vhat) + eps) + self._lamb_wd * p32
        w_norm, r_norm = _norm(p32), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        param.copy_(p32 - lr * trust * r)


class Lars(Momentum):
    """LARS momentum: the step scaled per tensor by ``lars_coeff·|w| /
    (|g| + lars_weight_decay·|w| + epsilon)`` (1 where either norm is 0),
    the gradient with ``lars_weight_decay`` times the weight."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 name=None, exclude_from_weight_decay=None, epsilon=0):
        _unported(exclude_from_weight_decay, "Lars exclude_from_weight_decay")
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name=name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._lars_eps = epsilon

    def _apply_one(self, name, param, grad, lr, step, slots):
        g = self._grad32(param, grad)
        p32 = param.float()
        p_norm, g_norm = _norm(p32), _norm(g)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._lars_coeff * p_norm / (g_norm + self._lars_wd * p_norm
                                         + self._lars_eps), 1.0)
        upd = g + self._lars_wd * p32
        vel = slots["velocity"]
        vel.copy_(self._momentum * vel + lr * local_lr * upd)
        param.copy_(p32 - vel)
