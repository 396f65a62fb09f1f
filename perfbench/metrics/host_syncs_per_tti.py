"""Host calls that wait for the device per TTI in the traced window: the
CUDA runtime's stream, device and event synchronisations and blocking
copies (profiler). Nothing where the trace holds no runtime call."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    if not any(e.cat == "cuda_runtime" for e in run.trace.host):
        return None
    return run.trace.syncs() / run.trace.steps
