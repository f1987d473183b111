"""Serving telemetry — re-export shim (as ``paddle_tpu/inference/
telemetry.py``): the substrate lives in :mod:`paddle_tpu_torch.telemetry`,
which the training tier shares; serving code imports it from here."""
from ..telemetry import (DEFAULT_BUCKETS, NULL_FLIGHT,  # noqa: F401
                         NULL_TRACER, TRAIN_RID, Counter, FlightRecorder,
                         Gauge, GoodputLedger, Histogram, MetricsRegistry,
                         ServingTelemetry, SpanTracer, TrainTelemetry,
                         train_watchdog, watchdog)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SpanTracer", "FlightRecorder", "ServingTelemetry", "watchdog",
           "DEFAULT_BUCKETS", "NULL_TRACER", "NULL_FLIGHT"]
