"""setup_s: from the process's start to the first timed call: imports,
the kernels' build (first run of a checkout only), the inputs, the
program's build and warm-up calls."""


def read(run):
    return run.setup_s
