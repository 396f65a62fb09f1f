"""Sharding over ``torch.distributed``: carriers (``mesh.shard_decode``),
time blocks of the sample stream (``timeshard``) and turbo windows
(``turbo_shard``), one process per rank (``mesh.launch``); counterpart of
``srsue_tpu/parallel``. ``ranks`` holds the functions that a launch runs on
each rank."""
