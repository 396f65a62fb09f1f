"""The reference's UE (``Ue`` + ``Phy``, JAX on the CPU) attaches over the
air to the port's eNB emulator (``EnbPhy(device="cpu")``), and the port's
UE to its own eNB, each at the same TTI and with the same eNB events as the
reference UE with the reference eNB."""

import pytest

from tests.test_torch_ota_lockstep import attach_across


@pytest.fixture(scope="module")
def ref_with_ref():
    return attach_across("ref", "ref")


def test_reference_ue_attaches_to_the_port_enb(ref_with_ref):
    tti, events = attach_across("ref", "port")
    assert (tti, events) == ref_with_ref


def test_port_ue_attaches_to_the_port_enb(ref_with_ref):
    tti, events = attach_across("port", "port")
    assert (tti, events) == ref_with_ref
