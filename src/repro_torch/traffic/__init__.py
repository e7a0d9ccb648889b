"""Trace-driven traffic subsystem (`repro.traffic`, DESIGN.md §13).

  samplers — seeded request-stream draws on `core.prng`: Zipfian key
             popularity, Poisson / on-off-burst arrivals, a Bernoulli
             read/write mix;
  trace    — the columnar `RequestTrace`, generated on a device from a
             config and seed, saved and loaded in the reference's .npz
             format;
  driver   — per-agent streams plus a cursor, and the harness predicates
             (can_local / can_remote / remote_bound / ...) derived from
             them.

`repro_torch.workloads.kv_serving` is their consumer.
"""
from repro_torch.traffic.samplers import TrafficConfig  # noqa: F401
from repro_torch.traffic.trace import RequestTrace      # noqa: F401
