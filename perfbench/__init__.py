"""The benchmark of srsue_tpu_torch: one cell per run (``run.py``)."""
