"""build_span_ms.step: device milliseconds a tree build of the step,
from the program's spans: the device time launched under the `build`
spans of a profiled step after the window (portbench.spans) over their
count (two a step: each build's graph replay, its copies and its overflow
read)."""

from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.span_intervals("build"):
        return None
    return 1e3 * st.device_s_under("build") / len(st.span_intervals("build"))
