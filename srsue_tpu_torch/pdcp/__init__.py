"""The port's own copy of ``srsue_tpu/pdcp/__init__.py`` (its reference), unchanged below this docstring.

PDCP layer (reference: ue/src/upper/pdcp.cc + pdcp_entity.cc)."""

from .pdcp import Pdcp, PdcpConfig
