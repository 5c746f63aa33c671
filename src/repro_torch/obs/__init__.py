"""The observability plane (DESIGN.md §14).

Opt-in recording and analysis over the netsim replay: a
:class:`~repro_torch.obs.recorder.Recorder` attached to the simulator captures
every verb's exact service interval and queue/dependency decomposition
(pure post-hoc observation — recording off is bit-identical to today),
:mod:`repro_torch.obs.export` renders runs as Chrome/Perfetto trace-viewer
JSON plus derived time series, :mod:`repro_torch.obs.forensics` walks the
top-K slowest ops' dependency chains backwards into a four-component
latency attribution, and :mod:`repro_torch.obs.metrics` folds everything into
the ``RunResult.obs`` registry.  :mod:`repro_torch.obs.spans` is apart
from it: named spans inside the port's training step, on
``torch.profiler``'s clock.
"""
import importlib

# The names are loaded on first use, so that importing ``obs.spans`` (as
# the models do) does not load the index's core with this plane.
_HOME = {"Recorder": "recorder", "Segment": "recorder",
         "to_chrome_trace": "export", "write_chrome_trace": "export",
         "timeseries": "export", "attribute_ops": "forensics",
         "span_accounting": "forensics", "summarize": "metrics"}

__all__ = ["Recorder", "Segment", "to_chrome_trace", "write_chrome_trace",
           "timeseries", "attribute_ops", "span_accounting", "summarize"]


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"),
                   name)
