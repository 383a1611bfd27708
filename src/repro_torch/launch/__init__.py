"""Host-side solve tooling of the port: fault plans, preemption and lane
re-seeding (launch/faults.py), and the per-window telemetry of the
cost-model schedule controller (launch/telemetry.py)."""
