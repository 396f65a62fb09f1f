"""Cell and grant configuration. ``Cell`` holds the static cell parameters
and every quantity derived from them (FFT size, CP lengths, RE counts);
``DlGrant`` one TTI's PDSCH allocation. Frozen and hashable: the host
tables are cached per cell.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# 3GPP 36.211 Table 6.2.3-1: downlink bandwidth configurations.
# n_prb -> FFT size (standard sample rates: 15 kHz * nfft).
NFFT_BY_PRB = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}

N_SC_RB = 12          # subcarriers per resource block (normal CP, 15 kHz)
N_SYM_NORMAL = 7      # OFDM symbols per slot, normal CP
N_SYM_EXT = 6         # OFDM symbols per slot, extended CP
SLOTS_PER_SF = 2
SF_PER_FRAME = 10

MAX_PORTS = 4


def _cp_lengths(nfft: int, extended: bool) -> tuple[int, ...]:
    """CP length per OFDM symbol in one slot, scaled from the 2048-FFT
    reference values of 36.211 Table 6.12-1 (160/144 normal, 512 extended)."""
    if extended:
        return tuple([512 * nfft // 2048] * N_SYM_EXT)
    first = 160 * nfft // 2048
    rest = 144 * nfft // 2048
    return (first,) + (rest,) * (N_SYM_NORMAL - 1)


@dataclass(frozen=True)
class Cell:
    """Static cell configuration. Frozen + hashable: used as a cache key for
    all host-side precompute (sequences, RE maps) and as a static arg to
    jitted device functions."""

    n_prb: int = 6
    cell_id: int = 0             # PCI, 0..503
    n_ports: int = 1             # CRS ports: 1 (TM1) or 2 (TM2), 4 supported
    extended_cp: bool = False
    phich_duration: str = "normal"   # "normal" | "extended"
    phich_resources: float = 1.0     # Ng in {1/6, 1/2, 1, 2}

    def __post_init__(self):
        if self.n_prb not in NFFT_BY_PRB:
            raise ValueError(f"unsupported n_prb={self.n_prb}")
        if not 0 <= self.cell_id <= 503:
            raise ValueError(f"invalid cell_id={self.cell_id}")
        if self.n_ports not in (1, 2, 4):
            raise ValueError(f"invalid n_ports={self.n_ports}")

    # ---- derived geometry --------------------------------------------------
    @property
    def nfft(self) -> int:
        return NFFT_BY_PRB[self.n_prb]

    @property
    def srate(self) -> float:
        """Sample rate in Hz (15 kHz subcarrier spacing)."""
        return 15_000.0 * self.nfft

    @property
    def n_sc(self) -> int:
        """Occupied subcarriers."""
        return self.n_prb * N_SC_RB

    @property
    def n_sym_slot(self) -> int:
        return N_SYM_EXT if self.extended_cp else N_SYM_NORMAL

    @property
    def n_sym_sf(self) -> int:
        return 2 * self.n_sym_slot

    @property
    def cp_lengths(self) -> tuple[int, ...]:
        return _cp_lengths(self.nfft, self.extended_cp)

    @property
    def sf_len(self) -> int:
        """Time-domain samples per 1 ms subframe."""
        return 2 * (sum(self.cp_lengths) + self.n_sym_slot * self.nfft)

    @property
    def slot_len(self) -> int:
        return self.sf_len // 2

    @property
    def n_id_2(self) -> int:
        return self.cell_id % 3

    @property
    def n_id_1(self) -> int:
        return self.cell_id // 3

    @property
    def vshift(self) -> int:
        """CRS frequency shift v_shift = cell_id mod 6 (36.211 6.10.1.2)."""
        return self.cell_id % 6

    def replace(self, **kw) -> "Cell":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Grants (resource allocations)
# ---------------------------------------------------------------------------

# 36.211 Table 7.1.x modulation orders
MOD_BPSK, MOD_QPSK, MOD_16QAM, MOD_64QAM = 1, 2, 4, 6


@dataclass(frozen=True)
class DlGrant:
    """Downlink PDSCH allocation for one TTI (what
    ``srslte_dci_msg_to_dl_grant`` produces in the reference,
    ``ue/src/phy/phch_worker.cc:297``). Static per (prb, mcs) bucket."""

    n_prb: int                 # number of allocated PRBs (type-0 contiguous here)
    prb_start: int             # first allocated PRB
    mcs: int                   # MCS index 0..28
    mod_order: int             # bits/symbol: 2, 4 or 6
    tbs: int                   # transport block size in bits (payload, pre-CRC)
    rv: int = 0                # redundancy version 0..3
    ndi: bool = True

    @property
    def qm(self) -> int:
        return self.mod_order


