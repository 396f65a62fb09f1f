"""Torch PHY: the PDSCH receive chain and its host-side transmitter."""
