"""Compatibility shim, as `repro.core.worksteal`: the work-steal
simulator lives in `repro_torch.workloads.worksteal`, registered as a
workload of the pluggable harness.  Import from here for the stable
public API."""
from repro_torch.workloads.worksteal import (  # noqa: F401
    AppResult,
    ENGINES,
    QMETA,
    SCENARIOS,
    SimState,
    WSConfig,
    WorkStealSim,
    build_workload,
    reference_solution,
    run_app,
)
