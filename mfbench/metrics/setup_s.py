"""Seconds from the process's start to the window's first call: loading,
building the model, making the inputs, the first calls (compiling and
autotuning), less what the reference did there (an inference cell's BN
statistics)."""


def read(run):
    return run.setup_s
