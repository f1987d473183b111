"""Single-device train step — port of ``paddle_tpu/parallel/engine.py``
(``ParallelEngine``: ``build_train_step``, ``train_batch``, ``eval_batch``,
``engine_state_dict`` / ``set_engine_state``) for one device.

The JAX engine compiles the whole train step into one program over
donated parameters, optimizer state and step count, with the learning
rate a traced operand (``jax.jit(step_fn, donate_argnums=(0, 1, 2))``),
and the eval step into another. The port's engine trains the model's own
parameters in place, and on a CUDA device each step is a CUDA graph
replay (``graphs.py``, shared with the serving executor): one graph per
key — the batch's shapes and dtypes, ``model.training``, ``grad_accum``
and the remat policy, as JAX retraces on a new shape — over static input
buffers that each call fills (from pinned host memory for a host batch).
A train graph holds the whole step: zeroing the grads, the forward and
backward (``grad_accum``'s microbatches), a zero gradient for a parameter
the loss does not reach, the clip and the optimizer's update; an eval
graph the forward and the loss under ``no_grad``.

Trainable parameters (the JAX package's ``Parameter.trainable``): a
parameter with the attribute ``trainable = False`` is frozen; one without
the attribute is trainable (the port builds plain ``nn.Parameter``s, and
serving models build them with ``requires_grad=False``, so ``requires_grad``
cannot carry the notion). The engine trains the parameters that are
trainable and, when the optimizer was given an explicit parameter list,
in that list (``AdamW(parameters=lora_parameters(model))`` trains the
factors only; the JAX engine ignores the list and trains every trainable
parameter). Those get ``requires_grad`` on, gradients, optimizer state and
the update; every other parameter gets ``requires_grad`` off, no state,
and rides each step bit for bit unchanged. The graphs' weight key covers
every parameter, frozen ones included.

The learning rate and the step count live on the device, as the JAX
step's operands: before each step the host's ``get_lr()`` is copied into
a device fp32 scalar through pinned memory, and the step count is a
device int32 that the step itself increments (``_step_count`` is its host
mirror, which ``engine_state_dict`` reports). The update uses bias
correction at ``step_count + 1`` with the learning rate read before the
step; an ``LRScheduler`` is stepped on the host after it, and its next
rate reaches the graph through the scalar.

The first call of a key is the warm-up and a real step, counted once: it
runs eagerly on a side stream (creating the libraries' handles and the
kernels' build); the second call captures the graph, and it and every
later call replay it. The returned loss is a fresh tensor each call (a
clone of the graph's output). The graphs read the parameters, the
optimizer's slots and the buffers by address: one replaced since a
capture (``.to()``, a new ``Parameter``) raises at the next call;
updates in place (``set_engine_state``) are trained on. A capture that
fails raises; nothing falls back. The graphs share one memory pool, and
every ``torch.Generator`` the model's modules draw from (ERNIE's dropout)
is registered with them, so that a replay draws the masks an eager step
would. A step runs eagerly only by rule: on the CPU, under
``set_kernel_mode("reference")`` and with ``graphs`` set to False (a
measurement switch, as the executor's; the JAX engine has no such
argument). Launch counts add up per replay (``ops.captured_launches``),
equal to an eager step's.

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
scope is refused (NotImplementedError) rather than run without remat. On
a CUDA device a region's random draws are preserved through graph-safe
generator states (``recompute.RegionRng``), registered with the graphs.

``injector=`` (a :class:`~paddle_tpu_torch.faults.FaultInjector`) fires
its ``train_step`` site in :meth:`ParallelEngine.train_batch` before the
step's learning rate is set on the device and before its graph replays, so
a :class:`~paddle_tpu_torch.faults.StepFault` leaves the parameters, the
optimizer state, the step count and the lr untouched and the caller
retries the step verbatim (``kind="fatal"`` raises a plain
``RuntimeError``). ``telemetry=`` (a :class:`~paddle_tpu_torch.telemetry.
TrainTelemetry`) records each train step: ``t_dispatch`` after the step is
enqueued and ``t_wait`` after the stream is synchronised — the one
synchronise telemetry adds, as JAX's ``block_until_ready`` — with the
engine's CUDA graph captures during the step as its ``compiles``.
``telemetry=None`` (the default) keeps the step free of clock reads and
its loss unsynchronised.

``offload_opt_state=True`` keeps the optimizer's slots in pinned host
memory and streams them through the device around each parameter's
update in a window of ``PT_OFFLOAD_WINDOW`` staging sets
(``parallel/offload.py``), inside the step's graph. As the JAX engine it
refuses a mesh of more than one device (NotImplementedError),
``PT_MT_ADAMW``'s flat state (ValueError), an optimizer without a
per-parameter rule (NotImplementedError), and a model on the CPU
(NotImplementedError: no pinned host memory to offload to, as the JAX
CPU backend). ``remat_policy="offload_attn"`` keeps each layer's
``attn_out`` and ``mlp_out`` in pinned host buffers, one an anchor of the
step (``recompute.HostStash``), and recomputes the rest.

The module functions :func:`parallelize` and :func:`make_train_step` and
the methods :meth:`ParallelEngine.sync_to_model` (a no-op: the engine
trains the model's own parameters) and :meth:`ParallelEngine.state_dict`
are the JAX engine's.

The constructor keeps the JAX engine's parameter order. Not ported yet
(they raise NotImplementedError at any value but the JAX default): a mesh
of more than one device, ``fsdp``, ``batch_spec``, ``donate``,
``abstract`` and ``alias_model_params``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from .. import graphs
from ..faults import NULL_INJECTOR, FaultInjector, StepFault
from ..telemetry import TrainTelemetry
from ..distributed.fleet.recompute import (HostStash, RegionRng,
                                           check_remat_policy, host_stash,
                                           region_rng, remat_layers)
from .offload import OffloadedState, window_and_order

# the JAX engine's constructor arguments that the port does not take yet,
# each at the one value it accepts (the JAX default; ``batch_spec``'s
# ``P("data")`` equals the tuple ``("data",)``); any other value raises
# NotImplementedError. The constructor keeps the JAX engine's parameter
# order, so that a positional call means the same in both packages
_UNPORTED = {"fsdp": False, "batch_spec": ("data",), "donate": True,
             "abstract": False, "alias_model_params": False}


@dataclasses.dataclass
class _Program:
    """One key's static input buffers, whether its warm-up step has run,
    and its graph once captured."""

    inputs: tuple
    warm: bool = False
    graph: Optional[graphs.Graph] = None


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
            if offload_opt_state:
                raise NotImplementedError(
                    "offload_opt_state is single-device; multi-chip runs "
                    "shard the state over the mesh instead (ZeRO)")
            raise NotImplementedError("ParallelEngine over a mesh of more "
                                      "than one device is not ported yet")
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if injector is not None and not isinstance(injector, FaultInjector):
            raise ValueError(f"injector must be None or a FaultInjector, "
                             f"got {injector!r}")
        self.injector = injector or NULL_INJECTOR
        if telemetry is not None and \
                not isinstance(telemetry, TrainTelemetry):
            raise ValueError(f"telemetry must be None or a TrainTelemetry, "
                             f"got {telemetry!r}")
        # None (the default): no clock read and no synchronise a step
        self.telemetry = telemetry
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
        listed = (None if optimizer is None
                  or optimizer._parameter_list is None
                  else {id(p) for _, p in optimizer._parameter_list})
        self.trained = [(n, p) for n, p in self.named
                        if getattr(p, "trainable", True)
                        and (listed is None or id(p) in listed)]
        trained_ids = {id(p) for _, p in self.trained}
        for _, p in self.named:
            p.requires_grad_(id(p) in trained_ids)
        self._offload = None
        if offload_opt_state and optimizer is not None:
            self._offload = self._build_offload(optimizer)
        elif optimizer is not None:
            optimizer.init_state(self.trained)
        # JAX's step_count (donated, incremented by the step) and lr
        # operand, on the device; _step_count is the host mirror
        self._step_count = 0
        self._step_dev = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self._lr_dev = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self._train_step = None
        self.graphs = self.device.type == "cuda"
        self._programs = {}
        self._graph_pool = None
        self._weights = None
        self.captures = 0
        self.replays = {"train": 0, "eval": 0}
        # graph-safe RNG states of checkpointed regions (CUDA only)
        self._region_rng = (RegionRng(self.device)
                            if self.device.type == "cuda" else None)
        # the pinned host buffers of remat_policy="offload_attn"
        self.host_stash = HostStash()

    def _build_offload(self, optimizer):
        """The host-resident optimizer state (``offload_opt_state``), with
        the JAX engine's refusals."""
        from ..optimizer.optimizer import Optimizer

        if getattr(optimizer, "mt_active", lambda: False)():
            raise ValueError(
                "offload_opt_state and PT_MT_ADAMW are mutually exclusive "
                "(the flat state has no per-param layout to stream); unset "
                "one")
        if self.device.type != "cuda":
            raise NotImplementedError(
                f"offload_opt_state needs pinned host memory beside a CUDA "
                f"device; the model is on {self.device}")
        if type(optimizer)._apply_one is Optimizer._apply_one:
            raise NotImplementedError(
                "offload_opt_state needs a per-param update rule "
                "(_apply_one)")
        window, order = window_and_order()
        return OffloadedState(optimizer, self.trained, window, order)

    # ------------------------------------------------------------------ step
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

    def _train_body(self, batch):
        """One train step over the static inputs ``batch``, with no host
        read of a device value (the body of a train graph): zeroed grads,
        forward and backward (per microbatch), the update at the device
        step count + 1 with the device lr, the count incremented. Returns
        the loss."""
        opt = self.optimizer
        accum = self.grad_accum
        named = self.trained
        for _, p in named:
            p.grad = None
        rng = (contextlib.nullcontext() if self._region_rng is None
               else region_rng(self._region_rng))
        with rng, host_stash(self.host_stash):
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
        step = self._step_dev + 1
        opt.update([(n, p, g) for (n, p), g in zip(named, grads)],
                   self._lr_dev, step)
        self._step_dev.copy_(step)
        for _, p in named:
            p.grad = None
        return loss.detach()

    def _eval_body(self, batch):
        with torch.no_grad():
            return self._loss(batch).detach()

    def build_train_step(self):
        """The step function ``step(batch) -> loss`` (``batch`` a tuple of
        tensors or arrays), built on the first ``train_batch``: the key's
        program — its graph on a CUDA device — run once."""
        def step(batch):
            return self._run("train", self._train_body, batch)

        self._train_step = step
        return step

    def train_batch(self, *batch):
        """One train step; returns the loss (a 0-d tensor on the device,
        not synchronised unless ``telemetry`` is attached). An injected
        ``train_step`` fault raises before anything on the device
        changes."""
        tel = self.telemetry
        if self._train_step is None:
            self.build_train_step()
        t0 = tel.clock() if tel is not None else 0.0
        batch = tuple(self._as_tensor(b) for b in batch)
        t_h2d = tel.clock() if tel is not None else 0.0
        if self.grad_accum > 1:
            for b in batch:
                if b.shape[0] % self.grad_accum:
                    raise ValueError(
                        f"grad_accum={self.grad_accum} needs the leading "
                        f"batch dim to divide evenly, got {tuple(b.shape)}")
        spec = self.injector.fire("train_step")
        if spec is not None:
            # before the lr is set and the step replays: the caller may
            # retry this step verbatim
            if spec.kind == "fatal":
                raise RuntimeError("injected fatal train-step fault")
            raise StepFault(f"injected train-step fault at step "
                            f"{self._step_count}")
        c0 = self.captures
        self._set_lr(self.optimizer.get_lr())
        loss = self._train_step(batch)
        if tel is not None:
            self._record_step(tel, batch, t0, t_h2d, self.captures - c0)
        self._step_count += 1
        sched = self.optimizer._learning_rate
        if hasattr(sched, "step"):
            sched.step()
        return loss

    def _record_step(self, tel, batch, t0, t_h2d, compiles) -> None:
        """The telemetry of one train step (JAX's prog key, token count and
        phase timestamps): ``t_dispatch`` now, with the step enqueued,
        ``t_wait`` after the stream has run it."""
        t_dispatch = tel.clock()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t_wait = tel.clock()
        if not tel.model_params:
            tel.model_params = sum(p.numel() for _, p in self.trained)
        first = batch[0] if batch else None
        tokens = 0 if first is None else \
            int(np.prod(first.shape[:2])) if first.ndim >= 2 \
            else int(first.shape[0])
        prog = "train:" + ";".join("x".join(map(str, b.shape))
                                   for b in batch)
        tel.record_step(step=self._step_count, prog=prog, tokens=tokens,
                        t0=t0, t_h2d=t_h2d, t_dispatch=t_dispatch,
                        t_wait=t_wait, compiles=compiles)

    def eval_batch(self, *batch):
        """The loss of one batch under ``no_grad`` (on a CUDA device a
        graph replay); a 0-d tensor, not synchronised."""
        return self._run("eval", self._eval_body,
                         tuple(self._as_tensor(b) for b in batch))

    # ----------------------------------------------------------- programs
    @staticmethod
    def _as_tensor(b):
        return b if isinstance(b, torch.Tensor) else torch.as_tensor(
            np.asarray(b))

    def _pinned(self, t):
        """A host tensor in pinned memory on a CUDA engine (the copy to
        the device is then asynchronous; the caching host allocator keeps
        the block until that copy has run)."""
        if self.device.type == "cuda" and not t.is_pinned():
            return t.pin_memory()
        return t

    def _set_lr(self, lr: float) -> None:
        self._lr_dev.copy_(self._pinned(torch.tensor(lr,
                                                     dtype=torch.float32)),
                           non_blocking=True)

    def _use_graphs(self) -> bool:
        from .. import ops

        return self.graphs and ops.kernel_mode() != "reference"

    def _run(self, kind, body, batch):
        """Run ``body`` over the static inputs of ``batch``'s key: eagerly
        (by rule, or the key's warm-up step), by capturing its graph (the
        key's second call) and replaying it."""
        key = (kind, tuple((tuple(b.shape), b.dtype) for b in batch),
               self.model.training, self.grad_accum, self.remat,
               self.remat_policy)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(tuple(
                torch.empty(b.shape, dtype=b.dtype, device=self.device)
                for b in batch))
        for dst, src in zip(prog.inputs, batch):
            dst.copy_(src if src.device.type != "cpu" else self._pinned(src),
                      non_blocking=True)
        run = functools.partial(body, prog.inputs)
        if not self._use_graphs():
            return run()
        if self._weights is not None:
            self.check_weights()
        if prog.graph is None:
            if not prog.warm:
                out = graphs.warm_up(run, self.device)
                prog.warm = True
                if out.is_cuda:      # made on the side stream, used here
                    out.record_stream(torch.cuda.current_stream(self.device))
                return out
            prog.graph = self._capture(run)
        self.replays[kind] += 1
        return prog.graph.replay().clone()

    def _capture(self, run):
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        # the warm-ups' freed blocks back to the device before the graph
        # takes its own pool
        torch.cuda.empty_cache()
        gens = self._generators()
        if self._region_rng is not None:
            gens += self._region_rng.generators()
        graph = graphs.capture(run, gens, self._graph_pool)
        self.captures += 1
        if self._weights is None:
            self._weights = self._weights_key()
        return graph

    def _generators(self):
        """The CUDA ``torch.Generator``s the model's modules draw from,
        other than the default one (registered by PyTorch itself)."""
        out = []
        for m in self.model.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and g.device.type == "cuda" \
                    and all(g is not h for h in out):
                out.append(g)
        if out:
            idx = self.device.index
            default = torch.cuda.default_generators[
                torch.cuda.current_device() if idx is None else idx]
            out = [g for g in out if g is not default]
        return out

    def _weights_key(self):
        slots = [t for s in self.optimizer._accumulators.values()
                 for t in s.values()]
        return graphs.weights_key(self.model.parameters(),
                                  self.model.buffers(), slots)

    def check_weights(self) -> None:
        """Raise RuntimeError when a parameter, buffer or optimizer slot
        is no longer the tensor, at the address, the graphs were captured
        over."""
        if self._weights is not None and \
                self._weights_key() != self._weights:
            raise RuntimeError("the model's weights or the optimizer's "
                               "state were replaced after the engine's "
                               "graphs were captured: build a new "
                               "ParallelEngine for the changed model")

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
        accs = self.optimizer._accumulators
        for n, slots in state["opt_state"].items():
            live = accs[n] if n in accs else \
                self.optimizer._slots_for(n, params[n])
            for k, v in slots.items():
                live[k].copy_(torch.as_tensor(np.asarray(v)))
        self._step_count = int(state.get("step", 0))
        self._step_dev.fill_(self._step_count)

    def sync_to_model(self) -> None:
        """The JAX engine copies its trained arrays back into the model's
        parameters; the port's engine trains those parameters in place,
        so there is nothing to copy."""

    def state_dict(self):
        """The model's ``state_dict()`` after :meth:`sync_to_model`."""
        self.sync_to_model()
        return self.model.state_dict()


def parallelize(model, optimizer=None, loss_fn=None, mesh=None,
                **kwargs) -> ParallelEngine:
    return ParallelEngine(model, optimizer=optimizer, loss_fn=loss_fn,
                          mesh=mesh, **kwargs)


def make_train_step(model, loss_fn, optimizer, mesh=None, **kwargs):
    """A :class:`ParallelEngine` with its train step built."""
    eng = ParallelEngine(model, optimizer=optimizer, loss_fn=loss_fn,
                         mesh=mesh, **kwargs)
    eng.build_train_step()
    return eng
