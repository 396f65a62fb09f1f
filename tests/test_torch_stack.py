"""The port's protocol stack against the reference's.

* The reference's own stack tests (MAC, RLC, PDCP/USIM, RRC codecs, SI
  scheduling, the hermetic attach, re-establishment, handover, paging
  occasions and PCCH, A3 measurement reporting) run again on the port's
  modules: the same scenarios, the same expectations.
* Every MAC scenario of ``tests/test_mac.py`` runs on both packages, and
  every MAC PDU packed or parsed (and every RAR PDU) is byte-equal.
* The hermetic attach selftest (``main.run_selftest_inline``) of both
  packages, with the UE identity, RAND and GUTI drawn from the same seeded
  stream: every MAC and RLC PDU of both directions is byte-equal, and both
  attach and move their packets.
"""

import argparse
import ast
import contextlib
import io
import random
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCENARIO_FILES = ("test_mac", "test_rlc", "test_rlc_reseg", "test_pdcp_usim", "test_rrc_uper",
                  "test_si_sched", "test_usim_xor", "test_attach_e2e", "test_reestablish",
                  "test_handover", "test_paging", "test_meas_report")
# the over-the-air scenarios of those files run in tests/test_torch_mobility.py
OTA_SCENARIOS = ("test_paging_over_the_air", "test_ota_a3_measurement_triggers_handover")


def _source(name: str, pkg: str) -> str:
    src = (REPO / "tests" / f"{name}.py").read_text()
    return src if pkg == "srsue_tpu" else re.sub(r"\bsrsue_tpu\b", pkg, src)


def _load(name: str, pkg: str) -> dict:
    """The test module `name` of the reference, its imports pointed at `pkg`
    (helpers imported from another test module come from that module
    loaded the same way)."""
    ns = {"__name__": f"_scenarios_{name}_{pkg}"}
    src = _source(name, pkg)
    for mod, names in re.findall(r"^from (?:tests\.)?(test_\w+) import (.+)$", src, re.M):
        helpers = _load(mod, pkg)
        ns.update({n.strip(): helpers[n.strip()] for n in names.split(",")})
    src = re.sub(r"^from (?:tests\.)?test_\w+ import .+$", "", src, flags=re.M)
    exec(compile(src, f"tests/{name}.py [{pkg}]", "exec"), ns)
    return ns


def _scenarios(name: str) -> list[str]:
    tree = ast.parse((REPO / "tests" / f"{name}.py").read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


CASES = [(f, t) for f in SCENARIO_FILES for t in _scenarios(f) if t not in OTA_SCENARIOS]


@pytest.mark.parametrize("name, scenario", CASES, ids=[f"{f}::{t}" for f, t in CASES])
def test_reference_scenario_on_the_port(name, scenario):
    ns = _load(name, "srsue_tpu_torch")
    assert "srsue_tpu_torch" in _source(name, "srsue_tpu_torch")
    ns[scenario]()


class _Recorder:
    """Wraps the PDU functions of one package's ``mac.pdu`` (and its UE-side
    RLC container's read/write) to log every PDU that crosses them."""

    def __init__(self, monkeypatch, pkg: str, rlc: bool = False):
        import importlib

        self.log = []
        pdu = importlib.import_module(f"{pkg}.mac.pdu")
        for fn in ("pack", "pack_rar_pdu"):
            self._wrap(monkeypatch, pdu, fn, lambda r, a: ("out", bytes(r)))
        self._wrap(monkeypatch, pdu, "unpack", lambda r, a: (
            "in", bytes(a[0]), [(s.lcid, bytes(s.payload or b"")) for s in r.subheaders]))
        if rlc:
            cls = importlib.import_module(f"{pkg}.rlc.rlc").Rlc
            self._wrap(monkeypatch, cls, "read_pdu", lambda r, a: ("rlc ul", a[1], bytes(r or b"")))
            self._wrap(monkeypatch, cls, "write_pdu", lambda r, a: ("rlc dl", a[1], bytes(a[2])))

    def _wrap(self, monkeypatch, owner, fn, entry):
        orig = getattr(owner, fn)

        def wrapped(*a, **kw):
            r = orig(*a, **kw)
            self.log.append((fn, entry(r, a)))
            return r

        monkeypatch.setattr(owner, fn, wrapped)


@pytest.mark.parametrize("scenario", _scenarios("test_mac"))
def test_mac_scenario_gives_the_references_pdus(scenario, monkeypatch):
    logs = {}
    for pkg in ("srsue_tpu", "srsue_tpu_torch"):
        rec = _Recorder(monkeypatch, pkg)
        _load("test_mac", pkg)[scenario]()
        logs[pkg] = rec.log
    assert logs["srsue_tpu_torch"] == logs["srsue_tpu"]


class _SeededOs:
    """``os`` for a module whose only use of it is ``os.urandom``."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def urandom(self, n: int) -> bytes:
        return bytes(self._rng.getrandbits(8) for _ in range(n))


def test_selftest_attach_in_lockstep_with_the_reference(monkeypatch):
    import importlib

    runs = {}
    for pkg in ("srsue_tpu", "srsue_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(f"{pkg}.rrc.rrc"), "os", _SeededOs(1))
        monkeypatch.setattr(importlib.import_module(f"{pkg}.enb.stack"), "os", _SeededOs(2))
        rec = _Recorder(monkeypatch, pkg, rlc=True)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = importlib.import_module(f"{pkg}.main").run_selftest_inline(
                argparse.Namespace(config=None, pcap=None))
        runs[pkg] = (rc, out.getvalue(), rec.log)
    (rc_r, out_r, log_r), (rc_p, out_p, log_p) = runs["srsue_tpu"], runs["srsue_tpu_torch"]
    assert rc_r == rc_p == 0
    assert "SELFTEST PASS: attached (rrc=CONNECTED, emm=REGISTERED)" in out_p
    assert "ul_pkts=True" in out_p and "dl_pkts=True" in out_p
    assert out_p == out_r
    macs = [e for e in log_r if e[0] != "read_pdu" and e[0] != "write_pdu"]
    assert len(macs) >= 4 and sum(1 for e in log_r if e[0] == "write_pdu") >= 10
    assert log_p == log_r
