"""Frozen copies of the LTE host tables (cell geometry, grants, sequences,
RE maps, CRCs, segmentation, DCI fields and the index maps of rate matching)
and of the host encoders the transmitter needs. They hold no receive
arithmetic: that is written out in ``receiver.py``. They are the
benchmark's yardstick and change with no program."""
