"""The port's own copy of ``srsue_tpu/usim/__init__.py`` (its reference), unchanged below this docstring.

Soft USIM + LTE security primitives (reference: ue/src/upper/usim.cc +
liblte/src/liblte_security.cc)."""
