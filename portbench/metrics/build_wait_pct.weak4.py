"""build_wait_pct.weak4: what the cards that hold no tree wait on card
0's build for: over every card but the mesh's first, the mean of 100 x
the card's idle seconds while the host is inside a `build` span (its
overflow read included) / the seconds of a profiled sharded call after
the window (portbench.spans)."""

from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.span_intervals("build"):
        return None
    first = run.entry.mesh.devices[0].index
    pct = [100.0 * st.idle_s_under(c, "build") / st.window_s
           for c in st.cards if c != first]
    return sum(pct) / len(pct) if pct else None
