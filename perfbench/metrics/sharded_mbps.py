"""Decoded Mbit/s of all the cards together: transport-block bits whose CRC
passed on every rank, over rank 0's window (host clock)."""

from perfbench.core import mbps as read  # noqa: F401
