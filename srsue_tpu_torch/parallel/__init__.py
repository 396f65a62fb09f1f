"""Sharding over ``torch.distributed``: carriers (``mesh.shard_decode``),
time blocks of the sample stream (``timeshard``) and turbo windows
(``turbo_shard``), one process per rank (``mesh.launch`` on one host; one
node process per host over ``tcp://``, ``multihost``); counterpart of
``srsue_tpu/parallel`` and ``tools/multihost_worker.py``. ``ranks`` holds
the functions that a launch runs on each rank."""
