"""Torch MAC: the DL HARQ entity over the port's device softbuffers."""
