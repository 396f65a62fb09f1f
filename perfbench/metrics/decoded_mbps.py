"""Decoded Mbit/s: transport-block bits whose CRC passed, over every step of
the window, divided by the window's wall time (host clock)."""

from perfbench.core import mbps as read  # noqa: F401
