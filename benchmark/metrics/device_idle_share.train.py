"""device_idle_share.train: the share of the traced window with no device operation running."""

from benchmark.measures import idle_share as read  # noqa: F401
