"""The port's LTE security primitives against the standards' vectors and
the reference. The reference takes AES from the ``cryptography`` package;
the port (``srsue_tpu_torch/usim/security.py``) carries its own AES-128, so
every function built on it -- ECB, CTR (EEA2), CMAC (EIA2), Milenage -- is
held to FIPS-197, RFC 4493 and 35.207 vectors and to the reference on
random inputs."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings, strategies as st

from srsue_tpu.usim import security as ref
from srsue_tpu_torch.usim import security as sec
from srsue_tpu_torch.usim.usim import AuthError, Usim, UsimConfig

REPO = Path(__file__).resolve().parent.parent
KEY16 = st.binary(min_size=16, max_size=16)


def test_aes128_fips197_appendix_c1():
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert sec.aes128_encrypt(key, pt) == bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")


def test_aes128_fips197_appendix_b_and_key_schedule():
    """Appendix B's cipher example and the last round key of its A.1 key
    expansion (w[40..43])."""
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    pt = bytes.fromhex("3243f6a8885a308d313198a2e0370734")
    assert sec.aes128_encrypt(key, pt) == bytes.fromhex("3925841d02dc09fbdc118597196a0b32")
    assert bytes(sec._round_keys(key)[10]) == bytes.fromhex("d014f9a8c9ee2589e13f0cc8b6630ca6")


def test_aes128_rejects_bad_lengths():
    with pytest.raises(ValueError):
        sec.aes128_encrypt(bytes(15), bytes(16))
    with pytest.raises(ValueError):
        sec.aes128_encrypt(bytes(16), bytes(17))


@pytest.mark.parametrize("msg, mac", [
    ("", "bb1d6929e95937287fa37d129b756746"),
    ("6bc1bee22e409f96e93d7e117393172a", "070a16b46b4d4144f79bdd9dd04a287c"),
    ("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e5130c81c46a35ce411",
     "dfa66747de9ae63030ca32611497c827"),
    ("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e5130c81c46a35ce411"
     "e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710", "51f0bebf7e3b9d92fc49741779363cfe"),
])
def test_aes_cmac_rfc4493_vectors(msg, mac):
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    assert sec.aes_cmac(key, bytes.fromhex(msg)) == bytes.fromhex(mac)


def test_milenage_35207_test_set_1():
    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    rand = bytes.fromhex("23553cbe9637a89d218ae64dae47bf35")
    sqn, amf = bytes.fromhex("ff9bb4d0b607"), bytes.fromhex("b9b9")
    op = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
    opc = sec.milenage_opc(k, op)
    assert opc == bytes.fromhex("cd63cb71954a9f4e48a5994e37a02baf")
    mac_a, mac_s = sec.milenage_f1(k, opc, rand, sqn, amf)
    assert mac_a == bytes.fromhex("4a9ffac354dfafb3")
    assert mac_s == bytes.fromhex("01cfaf9ec4e871e9")
    res, ck, ik, ak = sec.milenage_f2345(k, opc, rand)
    assert res == bytes.fromhex("a54211d5e3ba50bf")
    assert ck == bytes.fromhex("b40ba9a3c58b2a05bbf0d987b21bf8cb")
    assert ik == bytes.fromhex("f769bcd751044604127672711c6d3441")
    assert ak == bytes.fromhex("aa689c648370")
    assert sec.milenage_f5_star(k, opc, rand) == bytes.fromhex("451e8beca43b")


@settings(max_examples=40, deadline=None, database=None)
@given(key=KEY16, count=st.integers(0, 2**32 - 1), bearer=st.integers(0, 31),
       direction=st.integers(0, 1), msg=st.binary(max_size=100))
def test_eea2_and_eia2_equal_the_reference(key, count, bearer, direction, msg):
    ct = sec.eea2(key, count, bearer, direction, msg)
    assert ct == ref.eea2(key, count, bearer, direction, msg)
    assert sec.eea2(key, count, bearer, direction, ct) == msg
    assert sec.eia2(key, count, bearer, direction, msg) == ref.eia2(key, count, bearer,
                                                                    direction, msg)


def test_ctr_counter_wraps_modulo_2_128():
    """A counter block of all ones rolls over to zero, as CTR mode does."""
    key = bytes(range(16))
    iv = b"\xff" * 16
    ks = sec._aes_ctr(key, iv, bytes(32))
    assert ks[:16] == sec.aes128_encrypt(key, iv)
    assert ks[16:] == sec.aes128_encrypt(key, bytes(16))


@settings(max_examples=20, deadline=None, database=None)
@given(k=KEY16, op=KEY16, rand=KEY16, sqn=st.binary(min_size=6, max_size=6),
       amf=st.binary(min_size=2, max_size=2))
def test_milenage_and_kdf_equal_the_reference(k, op, rand, sqn, amf):
    opc = sec.milenage_opc(k, op)
    assert opc == ref.milenage_opc(k, op)
    assert sec.milenage_f1(k, opc, rand, sqn, amf) == ref.milenage_f1(k, opc, rand, sqn, amf)
    assert sec.milenage_f2345(k, opc, rand) == ref.milenage_f2345(k, opc, rand)
    assert sec.milenage_f5_star(k, opc, rand) == ref.milenage_f5_star(k, opc, rand)
    k_asme = sec.kdf_k_asme(opc, rand, sqn[:3], sqn)
    assert k_asme == ref.kdf_k_asme(opc, rand, sqn[:3], sqn)
    k_enb = sec.kdf_k_enb(k_asme, 7)
    for kind in ("rrc_enc", "rrc_int", "up_enc", "up_int"):
        assert sec.kdf_as(k_enb, 2, kind) == ref.kdf_as(k_enb, 2, kind)
    assert sec.kdf_nas(k_asme, 2, True) == ref.kdf_nas(k_asme, 2, True)
    assert sec.kdf_k_enb_star(k_enb, 301, 3100) == ref.kdf_k_enb_star(k_enb, 301, 3100)


def test_usim_derives_the_references_keys():
    """The port's USIM, given the reference's configuration, answers the
    same challenge with the same RES and derives the same K_ASME, NAS and
    AS keys; a bad AUTN is refused."""
    from srsue_tpu.usim.usim import Usim as RefUsim, UsimConfig as RefCfg

    cfg = RefCfg()
    mine_cfg = UsimConfig(imsi=cfg.imsi, imei=cfg.imei, k=cfg.k, op=cfg.op, algo=cfg.algo)
    u, r = Usim(mine_cfg), RefUsim(cfg)
    rand, sqn = os.urandom(16), bytes(6)
    _, _, _, ak = ref.milenage_f2345(cfg.k, r.opc, rand)
    mac_a, _ = ref.milenage_f1(cfg.k, r.opc, rand, sqn, cfg.amf)
    autn = bytes(a ^ b for a, b in zip(sqn, ak)) + cfg.amf + mac_a
    assert (u.generate_authentication_response(rand, autn, mcc=1, mnc=1)
            == r.generate_authentication_response(rand, autn, mcc=1, mnc=1))
    assert u.k_asme == r.k_asme
    for usim in (u, r):
        usim.generate_nas_keys(eea=2, eia=2)
        usim.generate_as_keys(nas_count=3, eea=2, eia=2)
    assert u.keys == r.keys
    with pytest.raises(AuthError):
        Usim(mine_cfg).generate_authentication_response(rand, bytes(16), 1, 1)


def test_the_port_needs_no_cryptography_package():
    """Importing the port's security module (and the stack above it) loads
    no ``cryptography``: the port runs where that package is not installed."""
    code = ("import sys; import srsue_tpu_torch.usim.security, srsue_tpu_torch.ue, "
            "srsue_tpu_torch.enb.stack; assert 'cryptography' not in sys.modules; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "cryptography" not in (REPO / "srsue_tpu_torch/usim/security.py").read_text().split(
        '"""', 2)[2]
