from repro_torch.kernels.fused_turn.ops import (  # noqa: F401
    BIG, TripPlan, plane_commit, plane_commit_many, plane_commit_ref,
    trip_plan, trip_plan_many, trip_plan_ref)
