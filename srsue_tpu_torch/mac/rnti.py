"""The well-known RNTIs (36.321 7.1), as in ``srsue_tpu/mac/mac.py``: the
port's one definition, which its MAC and PHY import."""

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE
RA_RNTI_BASE = 1
