"""95th percentile of a batch step's latency over every step of the window,
from the call until its outputs are on the host (host clock)."""

from perfbench.core import step_p95_ms as read  # noqa: F401
