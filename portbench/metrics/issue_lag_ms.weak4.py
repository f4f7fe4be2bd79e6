"""issue_lag_ms.weak4: what each card waits on before its range of the
chunks starts: over the cards, the mean of (the start of the card's first
device operation launched under its first `shard` span - that span's
host start), ms, in a profiled sharded call after the window
(portbench.spans): the copies and the issue ahead of the card's work."""

from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None:
        return None
    lag = {}
    for iv in st.span_intervals("shard"):
        for c in st.cards:
            if c not in lag:
                first = st.first_start_under(iv, c)
                if first is not None:
                    lag[c] = (first - iv[0]) / 1e6
    run.say(issue_lag_ms_by_card=lag)
    return sum(lag.values()) / len(lag) if lag else None
