"""Observability of the port (a subset of ``paddle_tpu.monitor``): the
gauge and histogram registry, the chrome-trace writer and spans, the
causal trace context of a request, and the crash flight recorder."""
from .flight import (FlightRecorder, arm_flight_recorder,
                     disarm_flight_recorder, dump_flight,
                     get_flight_recorder, host_id, set_host_id)
from .stats import (DEFAULT_HISTOGRAMS, Histogram, Stat, StatRegistry,
                    get_histogram, hist_delta, hist_observe, hist_quantile,
                    histogram_snapshot, reset_all_stats, stat_add, stat_get,
                    stat_names, stat_reset, stat_snapshot)
from .trace import (TraceWriter, get_writer, is_tracing, recording, span,
                    start_tracing, stop_tracing)
from .tracectx import TraceContext, mint_trace

__all__ = [
    "Stat", "StatRegistry", "stat_add", "stat_get", "stat_reset",
    "stat_names", "stat_snapshot", "reset_all_stats",
    "Histogram", "DEFAULT_HISTOGRAMS", "hist_observe", "get_histogram",
    "histogram_snapshot", "hist_delta", "hist_quantile",
    "TraceWriter", "get_writer", "is_tracing", "recording", "span",
    "start_tracing", "stop_tracing",
    "TraceContext", "mint_trace",
    "FlightRecorder", "arm_flight_recorder", "disarm_flight_recorder",
    "dump_flight", "get_flight_recorder", "set_host_id", "host_id",
]
