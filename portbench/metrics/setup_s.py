"""setup_s: seconds from the process's start to the first timed call
(imports, frames, the model, weights, warm-up; compiling in the first run
of a checkout), less the seconds the benchmark's reference spent
calibrating the weights."""


def read(ctx):
    return ctx["setup_s"]
