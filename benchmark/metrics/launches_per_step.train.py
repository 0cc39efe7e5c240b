"""launches_per_step.train: device operations in the trace per step."""

from benchmark.measures import ops_per_step as read  # noqa: F401
