"""Pluggable asymmetric-sharing workloads (`repro.workloads`).

Each registered module implements
`build(scenario, n_agents, seed=0, *, proto=None, device=None, **kw)
-> Bench` and `init_state(wl, seed, device)`.  The port registers four
of the reference's six: `worksteal` and `kv_serving` are not ported yet.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "kv_directory": "repro_torch.workloads.kv_directory",
    "producer_consumer": "repro_torch.workloads.producer_consumer",
    "producer_consumer_mc": "repro_torch.workloads.producer_consumer_mc",
    "reader_lock": "repro_torch.workloads.reader_lock",
}


def available():
    return sorted(_MODULES)


def get(name: str):
    """The registered workload module (lazy import)."""
    if name not in _MODULES:
        raise KeyError(f"unknown workload {name!r}; "
                       f"available: {available()}")
    return importlib.import_module(_MODULES[name])
