"""Radio front ends: the IQ stream a ``Receiver`` reads (``radio.py``)."""

from .radio import ArrayRadio, FileRadio, Radio
