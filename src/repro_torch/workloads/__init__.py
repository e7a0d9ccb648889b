"""Pluggable asymmetric-sharing workloads (`repro.workloads`).

Each registered module implements
`build(scenario, n_agents, seed=0, *, proto=None, device=None, **kw)
-> Bench` and `VMAPPABLE`; every module but `worksteal` (which enqueues
on the host, `VMAPPABLE = False`) also `init_state(wl, seed, device)`,
which `harness.init_many` stacks over seeds for the replica engines.  The port registers all six of the
reference's workloads.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "worksteal": "repro_torch.workloads.worksteal",
    "kv_directory": "repro_torch.workloads.kv_directory",
    "kv_serving": "repro_torch.workloads.kv_serving",
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
