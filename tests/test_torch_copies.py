"""The stack modules that the torch port copies unchanged from the JAX
package: each copy's code is the reference's. The module docstring may
differ (the copy's names its reference file); everything after it must
parse to the same syntax tree. ``mac/mac.py``, ``phy/phy.py``,
``enb/phy.py``, ``usim/security.py`` and ``main.py`` are not copies: their
own tests hold their behaviour to the reference's."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

COPIES = (
    "utils/timers.py", "utils/metrics.py", "utils/pcap.py",
    "mac/pdu.py", "mac/demux.py", "mac/mux.py", "mac/procs.py", "mac/proc_ra.py",
    "rrc/__init__.py", "rrc/si_sched.py", "rrc/uper.py", "rrc/asn1.py", "rrc/messages.py",
    "rrc/rrc.py", "nas/__init__.py", "nas/messages.py", "nas/nas.py",
    "usim/__init__.py", "usim/usim.py",
    "rlc/__init__.py", "rlc/rlc.py", "rlc/rlc_am.py", "rlc/rlc_um.py", "rlc/rlc_tm.py",
    "pdcp/__init__.py", "pdcp/pdcp.py", "gw/__init__.py", "gw/gw.py",
    "enb/__init__.py", "enb/stack.py", "ue.py", "radio/socket_radio.py",
    "utils/logger.py", "radio/native_io.py",
)


def _code(path: Path) -> tuple[str, str]:
    """(ast.dump of the module without its docstring, the docstring)."""
    tree = ast.parse(path.read_text())
    doc = ast.get_docstring(tree, clean=False) or ""
    if doc:
        tree.body = tree.body[1:]
    return ast.dump(tree), doc


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference(rel):
    mine, doc = _code(REPO / "srsue_tpu_torch" / rel)
    ref, _ = _code(REPO / "srsue_tpu" / rel)
    assert f"``srsue_tpu/{rel}``" in doc, "the copy's header names its reference file"
    assert mine == ref


def test_every_stack_module_of_the_reference_has_its_port():
    """Every module of the layers above the PHY has its counterpart in the
    port at the same relative path."""
    for layer in ("mac", "rlc", "pdcp", "rrc", "nas", "usim", "gw", "enb"):
        for ref in (REPO / "srsue_tpu" / layer).glob("*.py"):
            assert (REPO / "srsue_tpu_torch" / layer / ref.name).is_file(), ref
    for rel in ("ue.py", "main.py", "phy/phy.py", "radio/socket_radio.py"):
        assert (REPO / "srsue_tpu_torch" / rel).is_file(), rel
