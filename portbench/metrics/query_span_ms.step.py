"""query_span_ms.step: device milliseconds a query of the step, from the
program's spans: the device time launched under the `query` spans of a
profiled step after the window (portbench.spans) over their count (two a
step: the query state, the slices and the tail)."""

from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.span_intervals("query"):
        return None
    return 1e3 * st.device_s_under("query") / len(st.span_intervals("query"))
