"""Rank 0's host ms a step in ``shard_decode``'s ``shard.exchange`` span: from
the ``all_reduce`` through its check on the host, so the rank's wait for its
own decode, for the slowest rank and for NCCL (program span, profiler clock)."""

from perfbench import spans


def read(run):
    return spans.ms_per_step(run, "shard.exchange")
