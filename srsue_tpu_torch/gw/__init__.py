"""The port's own copy of ``srsue_tpu/gw/__init__.py`` (its reference), unchanged below this docstring.

GW (IP gateway) layer (reference: ue/src/upper/gw.cc)."""

from .gw import Gw
