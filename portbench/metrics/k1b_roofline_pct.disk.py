"""k1b_roofline_pct.disk: 100 x the least time of the query's K1b calls
(portbench.roofline_k1b, summed over the live chunks, their inputs as
engine.kernel_inputs gives them on the tree the window left) / K1b's
device time a query (every csrc/shared_fused.cu kernel: plan, pack,
kernel, reduce). The reader's own seconds on standard error."""

import time

from portbench import roofline_k1b


def read(run):
    tree = getattr(run.entry, "tree", None)
    if run.trace is None or tree is None or not run.calls:
        return None
    from rakau_tpu_torch import engine
    k1b = run.trace.op_seconds(lambda n: "shared_fused" in n) / run.calls
    if k1b <= 0:
        return None
    t = time.perf_counter()
    td, cfg = tree.tree_data, tree.config
    bound, by = 0.0, {}
    for c in range(engine.live_chunks(td, cfg)):
        inputs = engine.kernel_inputs(td, cfg, run.entry.theta,
                                      run.entry.eps, c)
        s, what = roofline_k1b.k1b_bound(inputs, run.entry.n)
        bound += s
        by[what] = by.get(what, 0) + 1
    run.say(k1b_s_a_query=k1b, k1b_bound_s=bound, bound_by_chunks=by,
            k1b_reader_s=time.perf_counter() - t)
    return 100.0 * bound / k1b
