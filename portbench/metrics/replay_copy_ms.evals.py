"""replay_copy_ms.evals: device milliseconds a query of the graph
replays' copies: the device time launched under the program's
`graph.replay` spans by any runtime call but the graph's launch (the
static inputs' copy_ and the outputs' clones), in a profiled query after
the window (portbench.spans)."""

from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.span_intervals("graph.replay"):
        return None
    return 1e3 * st.device_s_under(
        "graph.replay", launched_by=lambda n: "GraphLaunch" not in n)
