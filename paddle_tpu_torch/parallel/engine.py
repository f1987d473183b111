"""Single-device train step — port of ``paddle_tpu/parallel/engine.py``
(``ParallelEngine``: ``build_train_step``, ``train_batch``, ``eval_batch``,
``engine_state_dict`` / ``set_engine_state``) for one device.

The JAX engine copies the model's parameters in, donates them to a jitted
step and returns new arrays. PyTorch runs eagerly, so the port's engine
trains the model's own parameters in place: every parameter is trained
(the port has no frozen parameters yet), the forward and backward run
through autograd (with the port's kernels on the card), and the optimizer
updates parameters and moments in place. The step counter and the LR
schedule follow the JAX engine: the update uses bias correction at
``step_count + 1`` with the learning rate read before the step, and an
``LRScheduler`` learning rate is stepped after it.

``remat=True`` recomputes activations in the backward under
``remat_policy`` (the JAX engine's names: ``"dots"``, ``"nothing"``,
``"save_attn"``, ``"save_attn_mlp"``, ``"save_qkv_attn"``, or None /
``"none"`` for a full recompute; see ``distributed/fleet/recompute.py``),
once per microbatch, one decoder layer at a time: the engine opens the
policy's scope and the model (``LlamaModel``) runs each layer as its own
checkpointed region, which keeps the layer's inputs and what the policy
saves. The JAX engine wraps the whole per-microbatch loss in
``jax.checkpoint`` and XLA recomputes it layer by layer; PyTorch replays a
checkpointed region as a whole at the backward's first use of it, so one
region over the whole loss would hold every activation at once in the
backward, as no remat does. A model that checkpoints no layer in the
scope is refused (NotImplementedError) rather than run without remat.

The constructor keeps the JAX engine's parameter order. Not ported yet
(they raise NotImplementedError at any value but the JAX default): a mesh
of more than one device, ``fsdp``, ``batch_spec``, ``donate``,
``abstract``, ``remat_policy="offload_attn"``, ``offload_opt_state``,
``alias_model_params``, ``injector`` and ``telemetry``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..distributed.fleet.recompute import check_remat_policy, remat_layers

# the JAX engine's constructor arguments that the port does not take yet,
# each at the one value it accepts (the JAX default; ``batch_spec``'s
# ``P("data")`` equals the tuple ``("data",)``, ``injector``'s null
# injector is None); any other value raises NotImplementedError. The
# constructor keeps the JAX engine's parameter order, so that a positional
# call means the same in both packages
_UNPORTED = {"fsdp": False, "batch_spec": ("data",), "donate": True,
             "abstract": False, "offload_opt_state": False,
             "alias_model_params": False, "injector": None,
             "telemetry": None}


class ParallelEngine:
    """Owns the train step of ``model`` (a ``LlamaForCausalLM`` or any
    module whose ``forward(*inputs, *labels)`` returns the loss when
    ``loss_fn`` is None, or whose outputs ``loss_fn(*outputs, *labels)``
    turns into one, as an ERNIE head with ``loss_fn=model.loss_fn``). The
    last element of a batch is the label; the others are the inputs.

    ``grad_accum=k`` splits each batch's leading dim into k contiguous
    microbatches, averages their losses and fp32-accumulated gradients and
    does one update. The engine runs where the model's parameters are: on
    the CUDA card for a model built there (the default), on the CPU (the
    plain PyTorch path) for one built with ``device="cpu"``; it raises
    when they span more than one device."""

    def __init__(self, model, optimizer=None,
                 loss_fn: Optional[Callable] = None, mesh=None,
                 fsdp: bool = False, remat: bool = False,
                 remat_policy: Optional[str] = "dots",
                 batch_spec=("data",), donate: bool = True,
                 abstract: bool = False, offload_opt_state: bool = False,
                 alias_model_params: bool = False, grad_accum: int = 1,
                 injector=None, telemetry=None):
        given = locals()
        for key, default in _UNPORTED.items():
            if given[key] != default:
                raise NotImplementedError(
                    f"ParallelEngine({key}=...) is not ported yet (the "
                    f"port's engine trains on one device)")
        if mesh is not None and getattr(mesh, "size", 1) > 1:
            raise NotImplementedError("ParallelEngine over a mesh of more "
                                      "than one device is not ported yet")
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.remat = bool(remat)
        self.remat_policy = remat_policy
        if self.remat:
            check_remat_policy(remat_policy)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        held = {p.device for p in model.parameters()}
        if len(held) != 1:
            raise ValueError(f"ParallelEngine trains on one device: the "
                             f"model's parameters are on "
                             f"{sorted(map(str, held))}")
        self.device = held.pop()
        self.named = list(model.named_parameters())
        for _, p in self.named:
            p.requires_grad_(True)
        if optimizer is not None:
            optimizer.init_state(self.named)
        self._step_count = 0
        self._train_step = None

    # ------------------------------------------------------------------ step
    def _to_device(self, b):
        t = b if isinstance(b, torch.Tensor) else torch.as_tensor(
            np.asarray(b))
        return t.to(self.device)

    def _step_loss(self, batch):
        """The loss of one (micro)batch, each decoder layer checkpointed
        under the remat policy when ``remat``."""
        if not self.remat:
            return self._loss(batch)
        with remat_layers(self.remat_policy) as scope:
            loss = self._loss(batch)
        if not scope.layers:
            raise NotImplementedError(
                f"remat=True checkpoints decoder layers, and "
                f"{type(self.model).__name__} ran none through "
                f"layer_checkpoint() (LlamaForCausalLM does)")
        return loss

    def _loss(self, batch):
        *inputs, label = batch
        if self.loss_fn is None:
            out = self.model(*inputs, label)
            return out[0] if isinstance(out, (list, tuple)) else out
        out = self.model(*inputs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        return self.loss_fn(*outs, label)

    def build_train_step(self):
        """The step function ``step(batch) -> loss`` (host-side Python:
        there is nothing to compile); built on the first ``train_batch``."""
        opt = self.optimizer
        accum = self.grad_accum
        named = self.named

        def step(batch):
            lr = opt.get_lr()
            for _, p in named:
                p.grad = None
            if accum == 1:
                loss = self._step_loss(batch)
                loss.backward()
                # a parameter the loss does not reach (an ERNIE masked-LM
                # head's pooler) gets a zero gradient, as jax.grad gives
                # it: AdamW still decays it and steps its moments
                grads = [p.grad if p.grad is not None else
                         torch.zeros_like(p) for _, p in named]
            else:
                mbs = list(zip(*(b.chunk(accum) for b in batch)))
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for _, p in named]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
                for mb in mbs:
                    l_mb = self._step_loss(mb)
                    l_mb.backward()
                    loss += l_mb.detach().float()
                    for a, (_, p) in zip(acc, named):
                        if p.grad is not None:
                            a += p.grad.float()
                        p.grad = None
                loss = loss / accum
                grads = [a.div_(accum) for a in acc]
            opt.update([(n, p, g) for (n, p), g in zip(named, grads)], lr,
                       self._step_count + 1)
            self._step_count += 1
            for _, p in named:
                p.grad = None
            return loss.detach()

        self._train_step = step
        return step

    def train_batch(self, *batch):
        """One train step; returns the loss (a 0-d tensor on the device,
        not synchronised)."""
        if self._train_step is None:
            self.build_train_step()
        batch = tuple(self._to_device(b) for b in batch)
        if self.grad_accum > 1:
            for b in batch:
                if b.shape[0] % self.grad_accum:
                    raise ValueError(
                        f"grad_accum={self.grad_accum} needs the leading "
                        f"batch dim to divide evenly, got {tuple(b.shape)}")
        loss = self._train_step(batch)
        sched = self.optimizer._learning_rate
        if hasattr(sched, "step"):
            sched.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, *batch):
        return self._loss(tuple(self._to_device(b) for b in batch)).detach()

    # ------------------------------------------------------------------ state
    def engine_state_dict(self):
        """Host snapshot of the training state: ``{"params": {name: ndarray},
        "opt_state": {name: {slot: ndarray}}, "step": int}``. numpy has no
        bfloat16, so bf16 tensors come back widened (exactly) to float32."""
        def host(t):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy().copy()

        return {"params": {n: host(p) for n, p in self.named},
                "opt_state": {n: {k: host(v) for k, v in slots.items()}
                              for n, slots in
                              self.optimizer._accumulators.items()},
                "step": int(self._step_count)}

    @torch.no_grad()
    def set_engine_state(self, state):
        """Inverse of :meth:`engine_state_dict`: numpy (or tensors) in,
        copied into the live parameters and slots in their own dtypes."""
        params = dict(self.named)
        for n, v in state["params"].items():
            params[n].copy_(torch.as_tensor(np.asarray(v)))
        for n, slots in state["opt_state"].items():
            live = self.optimizer._slots_for(n, params[n])
            for k, v in slots.items():
                live[k].copy_(torch.as_tensor(np.asarray(v)))
        self._step_count = int(state.get("step", 0))
