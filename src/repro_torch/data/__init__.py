"""Input data of the port's workloads (`repro.data`)."""
