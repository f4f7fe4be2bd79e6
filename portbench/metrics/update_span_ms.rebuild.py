"""update_span_ms.rebuild: device milliseconds a tree update of the call,
from the program's spans: the device time launched under the `update`
spans of a profiled call after the window (portbench.spans), the nested
`build` included, over their count (one a call: Tree.update_positions_o's
gather, validation and build); the spans' host milliseconds on standard
error."""

from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.span_intervals("update"):
        return None
    iv = st.span_intervals("update")
    run.say(update_span_host_ms=[(b - a) / 1e6 for a, b in iv])
    return 1e3 * st.device_s_under("update") / len(iv)
