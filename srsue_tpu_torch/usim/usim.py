"""The port's own copy of ``srsue_tpu/usim/usim.py`` (its reference), unchanged below this docstring.

Soft USIM — AKA authentication + key derivation (reference:
ue/src/upper/usim.cc:38-240: config parse, Milenage/XOR auth with AUTN
validation, K_ASME/K_NAS/K_eNB/K_RRC/K_UP derivation)."""

from __future__ import annotations

from dataclasses import dataclass

from . import security as sec


@dataclass
class UsimConfig:
    imsi: str = "001010123456789"
    imei: str = "353490069873319"
    k: bytes = bytes(range(16))
    op: bytes = bytes(16)
    amf: bytes = b"\x80\x00"
    algo: str = "milenage"  # "milenage" | "xor"


class AuthError(Exception):
    pass


class Usim:
    def __init__(self, cfg: UsimConfig):
        self.cfg = cfg
        self.opc = sec.milenage_opc(cfg.k, cfg.op)
        self.k_asme: bytes | None = None
        self.k_enb: bytes | None = None
        self.keys: dict[str, bytes] = {}

    # --- usim_interface_nas ------------------------------------------------
    def get_imsi(self) -> str:
        return self.cfg.imsi

    def get_imei(self) -> str:
        return self.cfg.imei

    def generate_authentication_response(
        self, rand: bytes, autn: bytes, mcc: int, mnc: int
    ) -> bytes:
        """Validate AUTN, compute RES, derive K_ASME (usim.cc:136-240).

        AUTN = (SQN ^ AK)(6) || AMF(2) || MAC(8).
        Raises AuthError on MAC mismatch (network not authenticated).
        """
        if self.cfg.algo == "xor":
            return self._auth_xor(rand, autn, mcc, mnc)
        res, ck, ik, ak = sec.milenage_f2345(self.cfg.k, self.opc, rand)
        sqn_xor_ak = autn[:6]
        amf = autn[6:8]
        mac = autn[8:16]
        sqn = bytes(a ^ b for a, b in zip(sqn_xor_ak, ak))
        mac_a, _ = sec.milenage_f1(self.cfg.k, self.opc, rand, sqn, amf)
        if mac_a != mac:
            raise AuthError("AUTN MAC mismatch")
        plmn = self._plmn_bytes(mcc, mnc)
        self.k_asme = sec.kdf_k_asme(ck, ik, plmn, sqn_xor_ak)
        return res

    def _auth_xor(self, rand: bytes, autn: bytes, mcc: int, mnc: int) -> bytes:
        """34.108 §8 XOR test algorithm (reference usim.cc 'xor' branch):
        xdout = K ^ RAND; RES = xdout[0:8]; CK/IK = byte-rotations of
        xdout; AK from xdout[3:9]. AUTN MAC is validated against the
        same construction."""
        xdout = bytes(a ^ b for a, b in zip(self.cfg.k, rand))
        res = xdout[:8]
        ck = bytes(xdout[(i + 1) % 16] for i in range(16))
        ik = bytes(xdout[(i + 2) % 16] for i in range(16))
        ak = xdout[3:9]
        sqn_xor_ak = autn[:6]
        plmn = self._plmn_bytes(mcc, mnc)
        self.k_asme = sec.kdf_k_asme(ck, ik, plmn, sqn_xor_ak)
        return res

    @staticmethod
    def _plmn_bytes(mcc: int, mnc: int) -> bytes:
        d = [mcc // 100, (mcc // 10) % 10, mcc % 10]
        if mnc < 100:
            m = [0xF, mnc // 10, mnc % 10]
        else:
            m = [mnc // 100, (mnc // 10) % 10, mnc % 10]
        return bytes(
            [d[1] << 4 | d[0], m[0] << 4 | d[2], m[2] << 4 | m[1]]
        )

    # --- usim_interface_rrc ------------------------------------------------
    def generate_nas_keys(self, eea: int, eia: int) -> None:
        assert self.k_asme is not None
        self.keys["nas_enc"] = sec.kdf_nas(self.k_asme, eea, is_integrity=False)
        self.keys["nas_int"] = sec.kdf_nas(self.k_asme, eia, is_integrity=True)

    def generate_as_keys(self, nas_count: int, eea: int, eia: int) -> None:
        assert self.k_asme is not None
        self.k_enb = sec.kdf_k_enb(self.k_asme, nas_count)
        # 33.401 §7.2.8: the initial K_eNB is associated with NCC=0 and
        # the NH chain starts from it
        self.ncc = 0
        self.nh = self.k_enb
        self._derive_algo_keys(eea, eia)

    def _derive_algo_keys(self, eea: int, eia: int) -> None:
        self.keys["rrc_enc"] = sec.kdf_as(self.k_enb, eea, "rrc_enc")
        self.keys["rrc_int"] = sec.kdf_as(self.k_enb, eia, "rrc_int")
        self.keys["up_enc"] = sec.kdf_as(self.k_enb, eea, "up_enc")
        self.keys["up_int"] = sec.kdf_as(self.k_enb, eia, "up_int")

    def refresh_as_keys(self, pci: int, earfcn_dl: int, ncc: int,
                        eea: int, eia: int) -> None:
        """K_eNB* re-keying at re-establishment/handover (33.401 §7.2.8.4,
        36.331 §5.3.7.5): horizontal derivation from the current K_eNB
        when the signalled nextHopChainingCount equals the current NCC,
        vertical from the NH chain when it is larger."""
        assert self.k_asme is not None and self.k_enb is not None
        if ncc <= self.ncc:
            basis = self.k_enb  # horizontal: same (or stale) NCC
        else:
            # vertical: step the NH chain NH(i) = KDF(K_ASME, NH(i-1)),
            # seeded from the initial K_eNB, up to the signalled NCC
            while self.ncc < ncc:
                self.nh = sec.kdf_nh(self.k_asme, self.nh)
                self.ncc += 1
            basis = self.nh
        self.k_enb = sec.kdf_k_enb_star(basis, pci, earfcn_dl)
        self._derive_algo_keys(eea, eia)
