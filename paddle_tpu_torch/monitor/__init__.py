"""Observability of the port (a subset of ``paddle_tpu.monitor``): the
gauge and histogram registry with the memory gauges
(:func:`update_memory_stats`), the chrome-trace writer and spans, the
causal trace context of a request, the crash flight recorder, and
:class:`TrainerMonitor`, the per-step training telemetry that the hapi
``Monitor`` callback feeds from."""
from .flight import (FlightRecorder, arm_flight_recorder,
                     disarm_flight_recorder, dump_flight,
                     get_flight_recorder, host_id, set_host_id)
from .stats import (DEFAULT_HISTOGRAMS, Histogram, Stat, StatRegistry,
                    get_histogram, hist_delta, hist_observe, hist_quantile,
                    histogram_snapshot, prometheus_text, reset_all_stats,
                    stat_add, stat_get, stat_names, stat_reset,
                    stat_snapshot, update_memory_stats)
from .trace import (TraceWriter, get_writer, is_tracing, recording, span,
                    start_tracing, stop_tracing)
from .tracectx import TraceContext, mint_trace
from .trainer import TrainerMonitor

__all__ = [
    "Stat", "StatRegistry", "stat_add", "stat_get", "stat_reset",
    "stat_names", "stat_snapshot", "reset_all_stats", "update_memory_stats",
    "Histogram", "DEFAULT_HISTOGRAMS", "hist_observe", "get_histogram",
    "histogram_snapshot", "hist_delta", "hist_quantile", "prometheus_text",
    "TraceWriter", "get_writer", "is_tracing", "recording", "span",
    "start_tracing", "stop_tracing",
    "TraceContext", "mint_trace",
    "FlightRecorder", "arm_flight_recorder", "disarm_flight_recorder",
    "dump_flight", "get_flight_recorder", "set_host_id", "host_id",
    "TrainerMonitor",
]
