"""95th percentile over every TTI of the window of one ``UeDl.process``
call, from the IQ on the host to the ``DlResult`` (host clock)."""

from perfbench.core import step_p95_ms as read  # noqa: F401
