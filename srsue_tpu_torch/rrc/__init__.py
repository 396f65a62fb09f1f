"""The port's own copy of ``srsue_tpu/rrc/__init__.py`` (its reference), unchanged below this docstring.

RRC layer — message codecs + UE state machine (reference:
ue/src/upper/rrc.cc + liblte/src/liblte_rrc.cc)."""
