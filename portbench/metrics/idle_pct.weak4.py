"""idle_pct.weak4: 100 x (1 - the union of a card's device operations /
the traced window), the mean over the cards; each card's on standard
error."""


def read(run):
    if run.trace is None:
        return None
    run.say(idle_pct_by_card={c: run.trace.idle_pct(c)
                              for c in run.trace.cards})
    return run.trace.idle_pct()
