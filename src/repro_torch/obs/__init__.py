"""Runtime observability: run journals, span tracing, metrics, and the
contract-drift alarm.

Everything in this package runs on the host on finished results:
attaching a journal or a tracer never changes a run (pinned bit for bit
per engine in ``tests/test_torch_obs.py``).  See ``obs.journal`` for the
schema (the reference's), ``obs.report`` for the CLI, ``obs.trace`` for
spans timed by CUDA events, counters and ``torch_profiler``, and the
README's observability cookbook for the port.
"""

from .journal import (SCHEMA_VERSION, Journal, make_header, read_journal,
                      result_round_records, result_summary,
                      validate_journal, write_run_journal)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      byte_budget_for, check_byte_drift, result_metrics)
from .trace import (SpanRecord, Tracer, count, current_tracer, device_ops,
                    span, torch_profiler, tracing)

__all__ = [
    "Journal", "SCHEMA_VERSION", "make_header",
    "read_journal", "result_round_records", "result_summary",
    "validate_journal", "write_run_journal",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "byte_budget_for", "check_byte_drift", "result_metrics",
    "SpanRecord", "Tracer", "current_tracer", "torch_profiler",
    "device_ops", "span", "count", "tracing",
]
