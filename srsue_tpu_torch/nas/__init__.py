"""The port's own copy of ``srsue_tpu/nas/__init__.py`` (its reference), unchanged below this docstring.

NAS (EMM/ESM) layer — 24.301 message codecs + attach state machine
(reference: ue/src/upper/nas.cc + liblte/src/liblte_mme.cc)."""
