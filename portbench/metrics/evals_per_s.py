"""evals_per_s: particles x the window's complete calls / the window's
seconds / the cards the cell uses (BASELINE's evals/sec/chip)."""


def read(run):
    if not run.calls:
        return None
    return run.entry.n * run.calls / run.window_s / len(run.entry.cards)
