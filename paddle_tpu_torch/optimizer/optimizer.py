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
``param.grad`` of the trainable parameters (``trainable``, default True)
and counts its own steps; :meth:`Optimizer.minimize` runs the backward and
that step.

The surface around the update, as the JAX package's: ``set_lr`` (which
refuses while an ``LRScheduler`` drives the rate) and
``set_lr_scheduler``; ``state_dict`` / ``set_state_dict`` (``set_dict``)
with the keys ``<param name>.<slot>``, ``global_step`` and
``LR_Scheduler``, loaded IN PLACE into the live slots (a CUDA graph reads
them by address); ``clear_grad`` / ``clear_gradients``. A
``regularizer.L1Decay`` / ``L2Decay`` as ``weight_decay`` folds ``coeff ·
sign(w)`` / ``coeff · w`` into the gradient. Options the JAX package
accepts and ignores are accepted and ignored here too: Adam's
``lazy_mode``, Lamb's ``exclude_from_weight_decay_fn`` and Lars's
``exclude_from_weight_decay``. AdamW's ``lr_ratio`` scales a parameter's
learning rate in the eager :meth:`Optimizer.step` only (the JAX package's
compiled update does not read it).

``PT_MT_ADAMW=1`` (the JAX package's multi-tensor AdamW): where it applies
(no ``apply_decay_param_fun``, ``lr_ratio`` or ``multi_precision``, at
least two parameters of one dtype) :meth:`AdamW.init_state` lays every
parameter out, in sorted name order, in one flat ``(K, 512)`` buffer
padded to a multiple of 128 × 512 rows and makes each parameter a view
into it (the buffer is authoritative: a copy into a parameter writes
it), with fp32 ``moment1`` / ``moment2`` of the same shape (the state's
one entry ``"__mt__"``). An update concatenates the fp32 gradients into a
preallocated flat buffer and launches the AdamW kernel once over the
whole model.
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


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = (_named(parameters) if parameters is not None
                                else None)
        self._grad_clip = grad_clip
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._l2_coeff = float(weight_decay or 0.0)
            self._reg_mode = "l2"
        else:
            # a regularizer (``regularizer.L1Decay`` folds coeff·sign(w),
            # ``L2Decay`` coeff·w), read by its attributes as in JAX
            self._l2_coeff = float(getattr(
                weight_decay, "_coeff",
                getattr(weight_decay, "_regularization_coeff", 0.0)))
            self._reg_mode = getattr(weight_decay, "_mode", "l2")
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._global_step = 0
        # fp32 constants on each device, made at the first (eager) update:
        # a graph reads them by address
        self._consts: Dict[tuple, torch.Tensor] = {}
        self._step_scalars = None
        # the walk over the parameters when not _apply_all (offloaded
        # state)
        self._runner = None

    # ----------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        """A new constant learning rate (the engine copies it to the device
        at its next step); refused while a scheduler drives the rate."""
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "optimizer's learning rate can't be LRScheduler when invoke "
                "this API, because this will lead to conflict.")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        self._learning_rate = scheduler

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

    def state_dict(self) -> dict:
        """``{"<param name>.<slot>": tensor, "global_step": int}`` and,
        under a scheduler, ``"LR_Scheduler"``: its state. The tensors are
        the live slots (copy them to keep a snapshot)."""
        sd = {f"{name}.{slot}": t
              for name, slots in self._accumulators.items()
              for slot, t in slots.items()}
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict: dict) -> None:
        """Load :meth:`state_dict`'s keys: the step count, the scheduler's
        state, and each slot copied IN PLACE into the live slot of the
        parameter of that name (created first for a parameter of the
        optimizer's list that has none yet); keys of unknown parameters
        are skipped, as in the JAX package."""
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        params = dict(self._parameter_list or ())
        for key, v in state_dict.items():
            if key in ("global_step", "LR_Scheduler") or "." not in key:
                continue
            name, slot = key.rsplit(".", 1)
            if name in self._accumulators:
                slots = self._accumulators[name]
            elif name in params:
                slots = self._slots_for(name, params[name])
            else:
                continue
            v = torch.as_tensor(v)
            if slot in slots:
                slots[slot].copy_(v)
            else:
                slots[slot] = v.to(next(iter(slots.values())).device,
                                   torch.float32, copy=True)

    set_dict = set_state_dict

    # ---------------------------------------------------------------- step
    def _eager_params_grads(self):
        if self._parameter_list is None:
            raise ValueError("Optimizer created without explicit parameters; "
                             "pass parameters=model.named_parameters()")
        return [(n, p, p.grad) for n, p in self._parameter_list
                if getattr(p, "trainable", True) and p.grad is not None]

    def step(self):
        """Eager step over the optimizer's own trainable parameters'
        ``.grad``."""
        self._eager_update(self._eager_params_grads())

    def _eager_update(self, named_params_grads):
        """One eager step over ``[(name, param, grad)]`` (:meth:`step`, or
        ``amp.GradScaler`` with its unscaled fp32 gradients)."""
        self._global_step += 1
        self.update(named_params_grads, self.get_lr(), self._global_step)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then :meth:`step` (the JAX package's eager
        branch; there is no static program here). Returns (None, None)."""
        loss.backward()
        self.step()
        return None, None

    def update(self, named_params_grads, lr, step):
        """One optimizer step over ``[(name, param, grad)]``: clip, then
        each parameter's update rule, in place. ``lr`` (fp32) and ``step``
        (an integer, 1 for the first update) are 0-d tensors on the
        parameters' device; numbers are put there first. With ``_runner``
        set (``parallel.offload.OffloadedState``: the slots in host memory,
        each parameter's streamed in and out around :meth:`_apply_one`) it
        walks the parameters instead of :meth:`_apply_all`."""
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
                (self._runner or self._apply_all)(named_params_grads, lr,
                                                  step)
            finally:
                self._step_scalars = None

    def _apply_all(self, named_params_grads, lr, step):
        for name, p, g in named_params_grads:
            self._apply_one(name, p, g, lr, step, self._slots_for(name, p))

    def _begin(self, lr, step):
        """Per-step work shared by every parameter (Adam's scalars)."""
        return None

    def _grad32(self, param, grad):
        """The gradient in fp32, with ``weight_decay`` folded in where the
        optimizer takes it (``pure_update``): ``coeff · w`` (a float or
        ``L2Decay``) or ``coeff · sign(w)`` (``L1Decay``)."""
        g = grad.float()
        if self._l2_coeff:
            p32 = param.float()
            g = g + (self._l2_coeff * torch.sign(p32)
                     if self._reg_mode == "l1" else self._l2_coeff * p32)
        return g

    def clear_grad(self, set_to_zero: bool = True):
        for _, p in self._parameter_list or ():
            p.grad = None

    clear_gradients = clear_grad

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
        # lazy_mode (sparse rows) is accepted and ignored, as in JAX
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
    name ``apply_decay_param_fun`` accepts (all when it is None).
    ``lr_ratio(param)`` scales a parameter's learning rate in the eager
    :meth:`step` (as JAX's eager AdamW; its compiled update ignores it).
    Under ``PT_MT_ADAMW=1`` see the module docstring (the flat state)."""

    #: the flat state's row width and minimum tile (JAX's ``_MT_ROW``)
    MT_ROW = 512
    MT_TILE_ROWS = 128

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd_coeff = (float(weight_decay)
                          if isinstance(weight_decay, (int, float)) else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        self._eager_ratio = False
        # the flat multi-tensor state: (layout, total) once init_state
        # built it
        self._mt = None

    def _decay(self, name) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd_coeff

    def _eager_update(self, named_params_grads):
        self._eager_ratio = self._lr_ratio is not None
        try:
            super()._eager_update(named_params_grads)
        finally:
            self._eager_ratio = False

    def _apply_one(self, name, param, grad, lr, step, slots):
        if not self._eager_ratio:
            return super()._apply_one(name, param, grad, lr, step, slots)
        from ..ops.fused_adamw import adamw_scalars

        shared = self._step_scalars
        self._step_scalars = adamw_scalars(
            lr * float(self._lr_ratio(param)), step,
            self._const((self._beta1, self._beta2), lr.device))
        try:
            super()._apply_one(name, param, grad, lr, step, slots)
        finally:
            self._step_scalars = shared

    # ------------------------------------------ multi-tensor (flat) apply
    def mt_active(self) -> bool:
        """``PT_MT_ADAMW=1`` with uniform hyperparameters (JAX's
        ``_mt_active``: no decay mask, no lr ratio, no master weights)."""
        return (os.environ.get("PT_MT_ADAMW") == "1"
                and self._apply_decay_param_fun is None
                and self._lr_ratio is None and not self._multi_precision)

    @torch.no_grad()
    def init_state(self, named_params) -> None:
        named_params = list(named_params)
        if not self.mt_active() or len(named_params) < 2 or \
                len({p.dtype for _, p in named_params}) != 1:
            return super().init_state(named_params)
        layout = sorted(named_params, key=lambda np_: np_[0])
        total = sum(p.numel() for _, p in layout)
        unit = self.MT_TILE_ROWS * self.MT_ROW
        rows = -(-total // unit) * unit // self.MT_ROW
        p0 = layout[0][1]
        flat = torch.zeros(rows, self.MT_ROW, dtype=p0.dtype,
                           device=p0.device)
        view = flat.view(-1)
        off = 0
        for _, p in layout:
            n = p.numel()
            view[off:off + n].copy_(p.reshape(-1))
            # the parameter becomes a view into the flat buffer
            p.data = view[off:off + n].view(p.shape)
            off += n
        self._mt = ([(n, p) for n, p in layout], total)
        self._accumulators = {"__mt__": {
            "p": flat,
            "moment1": torch.zeros(flat.shape, dtype=torch.float32,
                                   device=flat.device),
            "moment2": torch.zeros(flat.shape, dtype=torch.float32,
                                   device=flat.device)}}
        # the gradients' fp32 concatenation, its padding zero
        self._mt_grad = torch.zeros(flat.shape, dtype=torch.float32,
                                    device=flat.device)

    def _apply_all(self, named_params_grads, lr, step):
        if self._mt is None:
            return super()._apply_all(named_params_grads, lr, step)
        from ..ops.fused_adamw import fused_adamw_update

        layout, total = self._mt
        grads = {n: g for n, _, g in named_params_grads}
        missing = [n for n, _ in layout if grads.get(n) is None]
        if missing:
            raise ValueError(
                f"PT_MT_ADAMW flat state cannot skip per-tensor work "
                f"(missing grads {missing[:3]}...); unset PT_MT_ADAMW for "
                f"this run")
        torch.cat([grads[n].reshape(-1).float() for n, _ in layout],
                  out=self._mt_grad.view(-1)[:total])
        mt = self._accumulators["__mt__"]
        fused_adamw_update(mt["p"], self._mt_grad, mt["moment1"],
                           mt["moment2"], scalars=self._step_scalars,
                           b1=self._beta1, b2=self._beta2, eps=self._epsilon,
                           decay=self._wd_coeff)


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
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        # accepted and ignored, as in the JAX package
        self._exclude_fn = exclude_from_weight_decay_fn
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
        # exclude_from_weight_decay is accepted and ignored, as in JAX
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
