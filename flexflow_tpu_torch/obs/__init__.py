"""Runtime observability: step tracing, step inspection, drift.

The port's counterpart of ``flexflow_tpu/obs``, writing the same
artifacts with the same fields: per-step phase spans (Chrome-trace /
Perfetto JSON and a JSONL stream, ``tracer.py``), the train step's
FLOPs, memory and collective census (``inspect.py``), a drift report of
the search's predicted step against the measured one (``drift.py``), a
windowed ``torch.profiler`` capture attributing each step's device time
to compute, collectives, transfers and idle, by kernel (``devtrace.py``),
the simulator's predicted schedule as lanes beside the measured ones
(``simtrace.py``), the per-op roofline (``roofline.py``) and the counter
registry the serving path and the traced loops write to
(``registry.py``).

Everything is inert unless a trace dir is set: ``make_tracer(None)``
returns the shared ``NULL_TRACER`` whose methods are no-ops, so the
training step pays nothing when observability is off.
"""

from flexflow_tpu_torch.obs.artifacts import artifact_header, write_artifact
from flexflow_tpu_torch.obs.devtrace import (
    NULL_CAPTURE,
    DeviceTraceCapture,
    attribution_report,
    make_capture,
    parse_profile_steps,
    record_step_metrics,
)
from flexflow_tpu_torch.obs.drift import collective_drift, drift_report
from flexflow_tpu_torch.obs.inspect import (
    collective_census,
    export_step_summary,
    inspect_compiled,
    inspect_model_step,
    model_context,
)
from flexflow_tpu_torch.obs.registry import CounterRegistry, get_registry
from flexflow_tpu_torch.obs.simtrace import (
    corpus_rows,
    sim_lane_events,
    simtrace_report,
    write_simtrace,
)
from flexflow_tpu_torch.obs.roofline import (
    class_aggregates,
    finish_aggregates,
    format_markdown,
    roofline_report,
)
from flexflow_tpu_torch.obs.tracer import (
    NULL_TRACER,
    NullTracer,
    StepTracer,
    make_tracer,
    merge_host_traces,
)

__all__ = [
    "artifact_header",
    "write_artifact",
    "NULL_CAPTURE",
    "DeviceTraceCapture",
    "attribution_report",
    "make_capture",
    "parse_profile_steps",
    "record_step_metrics",
    "collective_drift",
    "drift_report",
    "collective_census",
    "export_step_summary",
    "inspect_compiled",
    "inspect_model_step",
    "model_context",
    "CounterRegistry",
    "get_registry",
    "corpus_rows",
    "sim_lane_events",
    "simtrace_report",
    "write_simtrace",
    "class_aggregates",
    "finish_aggregates",
    "format_markdown",
    "roofline_report",
    "NULL_TRACER",
    "NullTracer",
    "StepTracer",
    "make_tracer",
    "merge_host_traces",
]
