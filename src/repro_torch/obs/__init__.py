"""Observability subsystem (`repro.obs`, DESIGN.md §11): in-engine event
tracing, log-bucketed latency histograms, and host-side trace export.

* `obs.trace`   — the `TraceLog` ring buffer carried inside the protocol
  `Store` and appended at the scoped-ISA dispatch choke point; a
  Python-level identity when disabled (the default).
* `obs.metrics` — log2 bucket math and bracketing percentiles.
* `obs.export`  — decode a ring buffer into Chrome-trace/Perfetto JSON
  and a text report.
* `obs.report`  — `python -m repro_torch.obs.report` (plus `--demo`).
"""
