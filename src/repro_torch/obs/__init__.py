"""The observability plane (DESIGN.md §14).

Opt-in recording and analysis over the netsim replay: a
:class:`~repro_torch.obs.recorder.Recorder` attached to the simulator captures
every verb's exact service interval and queue/dependency decomposition
(pure post-hoc observation — recording off is bit-identical to today),
:mod:`repro_torch.obs.export` renders runs as Chrome/Perfetto trace-viewer
JSON plus derived time series, :mod:`repro_torch.obs.forensics` walks the
top-K slowest ops' dependency chains backwards into a four-component
latency attribution, and :mod:`repro_torch.obs.metrics` folds everything into
the ``RunResult.obs`` registry.
"""
from repro_torch.obs.export import (timeseries, to_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.forensics import attribute_ops, span_accounting
from repro_torch.obs.metrics import summarize
from repro_torch.obs.recorder import Recorder, Segment

__all__ = ["Recorder", "Segment", "to_chrome_trace", "write_chrome_trace",
           "timeseries", "attribute_ops", "span_accounting", "summarize"]
