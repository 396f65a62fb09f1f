"""Seconds from the process's start to the first timed step: imports, CUDA
initialisation, the kernel library's build or load, the inputs, the warm-up."""


def read(run):
    return run.setup_s
