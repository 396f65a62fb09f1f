"""The port's own copy of ``srsue_tpu/enb/__init__.py`` (its reference), unchanged below this docstring.

Minimal eNodeB + core-network emulator for hermetic end-to-end tests
(the reference tests only against live eNBs over the air, SURVEY.md §4.3;
this package is the in-memory replacement)."""
