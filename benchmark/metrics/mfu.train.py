"""mfu.train: the step's matrix products and convolutions at the published peaks over the time per step."""

from benchmark.measures import mfu as read  # noqa: F401
