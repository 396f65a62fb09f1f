"""The well-known RNTIs (36.321 7.1), as in ``srsue_tpu/mac/mac.py``."""

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE
