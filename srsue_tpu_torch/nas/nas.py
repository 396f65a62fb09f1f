"""The port's own copy of ``srsue_tpu/nas/nas.py`` (its reference), unchanged below this docstring.

NAS EMM state machine — attach flow (reference: ue/src/upper/nas.cc:
DEREGISTERED -> REGISTERED; attach request w/ ESM PDN connectivity
(404-452), auth via USIM (274-313), security mode (328-385), attach
accept -> GW address (133-260), attach complete)."""

from __future__ import annotations

from enum import Enum, auto

from . import messages as M
from ..usim import security as sec


class EmmState(Enum):
    DEREGISTERED = auto()
    REGISTERED_INITIATED = auto()
    REGISTERED = auto()


class Nas:
    def __init__(self, usim=None, rrc=None, gw=None, mcc=1, mnc=1):
        self.usim = usim
        self.rrc = rrc
        self.gw = gw
        self.mcc = mcc
        self.mnc = mnc
        self.state = EmmState.DEREGISTERED
        self.count_ul = 0
        self.count_dl = 0
        # NAS UL COUNT snapshot for initial K_eNB derivation (33.401 §7.2.8:
        # the COUNT of the NAS message that established the connection)
        self.k_enb_nas_count = 0
        self.k_nas_int: bytes | None = None
        self.k_nas_enc: bytes | None = None
        self.eea = 0
        self.eia = 0
        self.ip_addr: str | None = None
        self.guti: bytes | None = None
        self.apn: str = "internet"
        self.attach_reject_cause: int | None = None
        self.service_reject_cause: int | None = None
        self.paging_pending = False

    # --------------------------------------------------------------- attach
    def attach_request(self) -> None:
        """User/upper trigger: start attach -> ask RRC for a connection."""
        self.state = EmmState.REGISTERED_INITIATED
        self.rrc.connect()

    def get_attach_request(self) -> bytes:
        esm = M.PdnConnectivityRequest().pack()
        return M.AttachRequest(imsi=self.usim.get_imsi(), esm_pdu=esm).pack()

    def notify_connection_setup(self) -> None:
        pass  # attach request already rode ConnectionSetupComplete

    # ------------------------------------------------------------ DL inbox
    def write_pdu(self, pdu: bytes) -> None:
        sec_type, mac4, seq, plain = M.secure_unwrap(pdu)
        if sec_type != M.SEC_NONE and self.k_nas_int is not None:
            want = sec.eia2(self.k_nas_int, self.count_dl, 0, 1, bytes([seq]) + plain)
            if want != mac4:
                return  # integrity failure
            self.count_dl += 1
        mt = M.msg_type_of(plain)
        if mt == M.MT_AUTH_REQUEST:
            self._handle_auth_request(M.AuthRequest.unpack(plain))
        elif mt == M.MT_SECURITY_MODE_COMMAND:
            self._handle_security_mode(M.SecurityModeCommand.unpack(plain))
        elif mt == M.MT_ATTACH_ACCEPT:
            self._handle_attach_accept(M.AttachAccept.unpack(plain))
        elif mt == M.MT_ATTACH_REJECT:
            # nas.cc:262-272: log cause, back to DEREGISTERED
            self.attach_reject_cause = M.AttachReject.unpack(plain).emm_cause
            self.state = EmmState.DEREGISTERED
        elif mt == M.MT_AUTH_REJECT:
            # nas.cc:315-321
            self.state = EmmState.DEREGISTERED
        elif mt == M.MT_IDENTITY_REQUEST:
            # reference stubs this (nas.cc:323); 24.301 §5.4.4 response
            self._send(M.IdentityResponse(self.usim.get_imsi()).pack())
        elif mt == M.MT_EMM_INFORMATION:
            pass  # network name/time info — nothing to act on (nas.cc:395)
        elif mt == M.MT_SERVICE_REJECT:
            # reference stubs this (nas.cc:387); 24.301 §5.6.1.5: back to
            # DEREGISTERED on cause #9/#10-class rejects
            self.service_reject_cause = M.ServiceReject.unpack(plain).emm_cause
            self.state = EmmState.DEREGISTERED
        elif mt == M.MT_ESM_INFORMATION_REQUEST:
            # reference stubs this (nas.cc:391); 24.301 §6.6.1: answer with
            # the requested APN so the MME can complete bearer setup
            req = M.EsmInformationRequest.unpack(plain)
            self._send(M.EsmInformationResponse(req.pti, self.apn).pack(),
                       integrity=True)
        elif mt == M.MT_DETACH_REQUEST:
            # network-initiated detach (capability-plus; absent in reference)
            self._send(M.DetachAccept().pack(), integrity=True)
            self.state = EmmState.DEREGISTERED
            self.ip_addr = None

    def _handle_auth_request(self, req: M.AuthRequest) -> None:
        from ..usim.usim import AuthError

        try:
            res = self.usim.generate_authentication_response(
                req.rand, req.autn, self.mcc, self.mnc
            )
        except AuthError:
            # network authentication failure: do not respond
            # (nas.cc:328-332 logs and drops the PDU)
            self.state = EmmState.DEREGISTERED
            return
        self._send(M.AuthResponse(res).pack())

    def _handle_security_mode(self, cmd: M.SecurityModeCommand) -> None:
        self.eea, self.eia = cmd.eea, cmd.eia
        self.usim.generate_nas_keys(cmd.eea, cmd.eia)
        self.k_nas_enc = self.usim.keys["nas_enc"]
        self.k_nas_int = self.usim.keys["nas_int"]
        self._send(M.SecurityModeComplete().pack(), integrity=True,
                   sec_type=M.SEC_INTEGRITY_NEW_CTX)

    def _handle_attach_accept(self, acc: M.AttachAccept) -> None:
        self.guti = acc.guti
        if acc.esm_pdu:
            bearer = M.ActivateDefaultBearerRequest.unpack(acc.esm_pdu)
            self.ip_addr = bearer.ip_addr
            if self.gw is not None:
                self.gw.setup_if_addr(bearer.ip_addr)
            esm_accept = M.ActivateDefaultBearerAccept(
                bearer.eps_bearer_id, bearer.pti
            ).pack()
        else:
            esm_accept = b""
        self._send(M.AttachComplete(esm_accept).pack(), integrity=True)
        self.state = EmmState.REGISTERED

    # ------------------------------------------------------------ UL outbox
    def _send(self, plain: bytes, integrity: bool = False,
              sec_type: int = M.SEC_INTEGRITY) -> None:
        if integrity and self.k_nas_int is not None:
            mac4 = sec.eia2(
                self.k_nas_int, self.count_ul, 0, 0,
                bytes([self.count_ul & 0xFF]) + plain,
            )
            out = M.secure_wrap(plain, self.count_ul, mac4, sec_type)
            self.count_ul += 1
        else:
            out = plain
        self.rrc.write_sdu_nas(out)

    def paging_received(self, id_kind: str) -> None:
        """RRC matched a paging record to us (capability-plus; the
        reference has no paging). In IDLE this would trigger a service
        request; here we record the event for the application layer."""
        self.paging_pending = True

    @property
    def is_registered(self) -> bool:
        return self.state == EmmState.REGISTERED
