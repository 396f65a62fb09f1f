"""Mean device ms per step of the turbo decode (``codec.decode_blocks``), by
CUDA events around it."""


def read(run):
    ms = run.spans.get("turbo")
    return sum(ms) / len(ms) if ms else None
