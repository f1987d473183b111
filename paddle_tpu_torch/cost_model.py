"""Op cost model and the analytic serving-tick cost model — port of
``paddle_tpu/cost_model.py`` (torch, numpy and the standard library only).

Two layers live here, as in the JAX package:

- :class:`CostModel` — the measured cost of one function: its time on the
  card from CUDA events (wall time for CPU tensors), its FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode`` and the bytes of its inputs
  and outputs. The JAX package reads all three from XLA's
  ``cost_analysis`` of the compiled program; the port measures the time
  and counts what PyTorch's flop counter counts (see :func:`flops`).
- :class:`PagedTickCostModel` — the analytic *serving* predictor: what a
  paged decode tick costs as a function of batch width, context blocks,
  and model size, with four scalar coefficients (host round-trip, fixed
  tick overhead, per-FLOP, per-byte) that start at documented priors and
  are calibrated online from measured autotune trials
  (``paddle_tpu_torch/autotune/cost.py`` drives the calibration loop).
  Its arithmetic is the JAX package's, term for term.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch


#: calls :meth:`CostModel.profile_measure` times
PROFILE_REPEATS = 10


def _tensors(obj):
    """Every tensor in a nest of tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class CostModel:
    def profile_measure(self, fn: Callable, *example_args, device=None,
                        fetch_cost_list=("time",)) -> Dict[str, Any]:
        """Cost of ``fn(*example_args)``: ``"flops"`` as
        ``FlopCounterMode`` counts them (matmuls, convolutions and
        attention: the products; elementwise work is not counted),
        ``"bytes accessed"`` the bytes of the inputs and the outputs, each
        once, and ``"time"`` the mean seconds of ``PROFILE_REPEATS`` calls
        after the counted one, from CUDA events when an input is on the
        card (wall time otherwise). ``device`` is accepted for the JAX
        signature; the inputs' device decides."""
        from torch.utils.flop_counter import FlopCounterMode

        with torch.no_grad():
            with FlopCounterMode(display=False) as fc:
                out = fn(*example_args)
            n_flops = float(fc.get_total_flops())
            ins = list(_tensors(example_args))
            nbytes = float(sum(t.numel() * t.element_size()
                               for t in ins + list(_tensors(out))))
            seconds = 0.0
            if "time" in fetch_cost_list:
                cuda = [t for t in ins if t.is_cuda]
                if cuda:
                    dev = cuda[0].device
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    with torch.cuda.device(dev):
                        start.record()
                        for _ in range(PROFILE_REPEATS):
                            fn(*example_args)
                        stop.record()
                        stop.synchronize()
                    seconds = start.elapsed_time(stop) / 1e3 / PROFILE_REPEATS
                else:
                    t0 = time.perf_counter()
                    for _ in range(PROFILE_REPEATS):
                        fn(*example_args)
                    seconds = (time.perf_counter() - t0) / PROFILE_REPEATS
        analysis = {"flops": n_flops, "bytes accessed": nbytes,
                    "seconds": seconds}
        return {"flops": n_flops, "bytes accessed": nbytes,
                "time": seconds, "analysis": analysis}

    def static_cost_data(self):
        return {}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """``paddle.flops``: the FLOPs of one forward pass of ``net`` over a
    zero float32 input of ``input_size`` on the net's device.

    Counting rule: ``FlopCounterMode``'s — 2 M N K a matrix product (and a
    convolution's or attention's products counted alike), nothing for
    elementwise work (bias adds, activations, norms, pooling). The JAX
    package counts through XLA's ``cost_analysis``, which adds the
    elementwise work, so the two agree on a net of bias-free products and
    the port's count is lower elsewhere (ROADMAP section C)."""
    from torch.utils.flop_counter import FlopCounterMode

    params = list(net.parameters()) if hasattr(net, "parameters") else []
    dev = params[0].device if params else torch.device("cpu")
    x = torch.zeros(tuple(input_size), dtype=torch.float32, device=dev)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(x)
    total = int(fc.get_total_flops())
    if print_detail:
        print(f"Total FLOPs: {total:,.0f}")
    return total


# --------------------------------------------------------------------------
# Analytic paged-tick serving cost model
# --------------------------------------------------------------------------

#: Reference shape the priors are anchored to — the suite's smallest
#: serving stand-in (~360k params, 8 decoding sequences, ~4 resident KV
#: blocks each at block_size=16/f32). The speculative break-even measured
#: at these shapes is ≈ k/2 accepted drafts per verify window
#: (gate_low = 2.0 at k = 4); the flop prior below is derived so the
#: uncalibrated model reproduces that measurement exactly. Calibration
#: from real trials then overrides all four coefficients.
REF_N_PARAMS = 360_000
REF_DECODING = 8
REF_CTX_BLOCKS = 4.0
REF_BLOCK_BYTES = 16_384

C_TRIP_PRIOR = 2e-3    # seconds per host<->device round trip
C_TICK_PRIOR = 4e-4    # fixed seconds per fused decode tick
C_BYTE_PRIOR = 1e-10   # seconds per HBM byte moved (~10 GB/s effective)

_REF_FLOPS = 2.0 * REF_N_PARAMS * REF_DECODING            # width = 1
_REF_BYTES = 4 * REF_N_PARAMS + REF_DECODING * REF_CTX_BLOCKS * REF_BLOCK_BYTES
# chosen so compute and (overhead + bytes) balance at the reference
# shape: tick(width=k+1)/tick(width=1) - 1 == k/2, i.e. break-even 2.0
# at k=4 — the speculative gate's threshold.
C_FLOP_PRIOR = (C_TICK_PRIOR + C_BYTE_PRIOR * _REF_BYTES) / _REF_FLOPS


@dataclasses.dataclass(frozen=True)
class TickShape:
    """What one fused decode tick looks like, in cost-relevant terms.

    ``width`` is tokens advanced per sequence per tick — 1 for plain
    decode, ``k + 1`` for a speculative verify window. KV-read bytes do
    not scale with width (the verify reads the same resident context the
    plain tick does); compute does.
    """

    decoding: int                       # sequences in decode this tick
    width: int = 1
    n_params: int = REF_N_PARAMS
    ctx_blocks: float = REF_CTX_BLOCKS  # mean resident KV blocks per seq
    block_bytes: int = REF_BLOCK_BYTES  # kv_block_bytes(cfg, bs, kv_quant)
    param_bytes: Optional[int] = None   # None = 4 bytes/param

    def flops(self) -> float:
        return 2.0 * self.n_params * self.decoding * self.width

    def hbm_bytes(self) -> float:
        pb = 4 * self.n_params if self.param_bytes is None \
            else self.param_bytes
        return float(pb) + self.decoding * self.ctx_blocks * self.block_bytes


class PagedTickCostModel:
    """``trip_seconds = c_trip + ticks * (c_tick + c_flop*flops +
    c_byte*bytes)`` — four coefficients, analytic features from
    :class:`TickShape`, priors anchored at the reference shape above and
    refined by :meth:`calibrate` from measured trials."""

    def __init__(self, c_trip: float = C_TRIP_PRIOR,
                 c_tick: float = C_TICK_PRIOR,
                 c_flop: float = C_FLOP_PRIOR,
                 c_byte: float = C_BYTE_PRIOR):
        self.c_trip = float(c_trip)
        self.c_tick = float(c_tick)
        self.c_flop = float(c_flop)
        self.c_byte = float(c_byte)

    # ------------------------------------------------------------ predict
    def tick_seconds(self, shape: TickShape) -> float:
        return (self.c_tick + self.c_flop * shape.flops()
                + self.c_byte * shape.hbm_bytes())

    def trip_seconds(self, shape: TickShape, ticks: int) -> float:
        """One host round trip running ``ticks`` fused ticks of this
        shape (``ticks`` = tick_window in steady-state decode)."""
        return self.c_trip + ticks * self.tick_seconds(shape)

    def predict(self, trips: float, ticks: float, flops: float,
                bytes_: float) -> float:
        """Seconds for aggregate trial totals (the calibration view)."""
        return (self.c_trip * trips + self.c_tick * ticks
                + self.c_flop * flops + self.c_byte * bytes_)

    def spec_break_even(self, k: int, shape: TickShape) -> float:
        """Accepted drafts per verify window where speculation pays:
        ``verify_window_cost / plain_tick_cost - 1``. At the reference
        shape this is k/2 — 2.0 for k = 4, ``SpecConfig.gate_low``'s default."""
        plain = self.tick_seconds(dataclasses.replace(shape, width=1))
        verify = self.tick_seconds(dataclasses.replace(shape, width=k + 1))
        return verify / plain - 1.0

    # ---------------------------------------------------------- calibrate
    def calibrate(self, trials: Sequence[Mapping[str, float]],
                  ridge: float = 1e-3) -> "PagedTickCostModel":
        """Fit the four coefficients to measured trials, regularized
        toward the current coefficients so a couple of trials refine the
        prior along measured directions without destroying it elsewhere.

        Each trial is a mapping with aggregate totals ``trips``,
        ``ticks``, ``flops``, ``bytes`` and the measured wall
        ``seconds``. Solved in prior-normalized coordinates (coefficient
        magnitudes span seven decades) as a ridge least-squares; returns
        a new model, never mutates."""
        import numpy as np

        if not trials:
            return PagedTickCostModel(self.c_trip, self.c_tick,
                                      self.c_flop, self.c_byte)
        prior = np.array([self.c_trip, self.c_tick,
                          self.c_flop, self.c_byte], dtype=np.float64)
        X = np.array([[t["trips"], t["ticks"], t["flops"], t["bytes"]]
                      for t in trials], dtype=np.float64)
        y = np.array([t["seconds"] for t in trials], dtype=np.float64)
        # u = c / prior, so the penalty ||u - 1|| is scale-free
        Xn = X * prior[None, :]
        G = Xn.T @ Xn
        lam = ridge * (np.trace(G) / 4.0 + 1e-30)
        u = np.linalg.solve(G + lam * np.eye(4),
                            Xn.T @ y + lam * np.ones(4))
        c = np.maximum(u, 0.0) * prior
        return PagedTickCostModel(*c.tolist())

    # -------------------------------------------------------------- (de)ser
    def to_dict(self) -> Dict[str, float]:
        return {"c_trip": self.c_trip, "c_tick": self.c_tick,
                "c_flop": self.c_flop, "c_byte": self.c_byte}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "PagedTickCostModel":
        return cls(**{k: float(d[k])
                      for k in ("c_trip", "c_tick", "c_flop", "c_byte")})
