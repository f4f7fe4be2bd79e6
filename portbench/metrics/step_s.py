"""step_s: the window's seconds over its complete leapfrog steps."""


def read(run):
    if not run.calls:
        return None
    return run.window_s / run.calls
