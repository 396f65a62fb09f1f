"""Torch MAC: the host protocol engine (``mac.py``) over the DL HARQ entity
of the port's device softbuffers, the UL HARQ, the PDU codec, mux/demux,
random access and BSR/SR/PHR."""
