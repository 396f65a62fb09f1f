"""Torch PHY: the blind control and PDSCH receive chain, the UE DL facade
and their host-side transmitter."""
