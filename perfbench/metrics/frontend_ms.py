"""Mean device ms per step of ``entry.stages``' frontend (OFDM demod, CRS
estimate, RE extract, ZF), by CUDA events around it."""


def read(run):
    ms = run.spans.get("frontend")
    return sum(ms) / len(ms) if ms else None
