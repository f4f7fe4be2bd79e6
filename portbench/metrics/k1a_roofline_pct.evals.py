"""k1a_roofline_pct.evals: 100 x the least time of the query's K1a calls
(portbench.roofline, summed over the live chunks, their inputs as
engine.kernel_inputs gives them after the window) / K1a's device time a
query (every csrc/shared_fused.cu kernel: plan, pack, kernel, reduce)."""

from portbench import roofline


def read(run):
    tree = getattr(run.entry, "tree", None)
    if run.trace is None or tree is None or not run.calls:
        return None
    from rakau_tpu_torch import engine
    k1a = run.trace.op_seconds(lambda n: "shared_fused" in n) / run.calls
    if k1a <= 0:
        return None
    td, cfg = tree.tree_data, tree.config
    bound, by = 0.0, {}
    for c in range(engine.live_chunks(td, cfg)):
        inputs = engine.kernel_inputs(td, cfg, run.entry.theta,
                                      run.entry.eps, c)
        s, what = roofline.k1a_bound(inputs, run.entry.n)
        bound += s
        by[what] = by.get(what, 0) + 1
    run.say(k1a_s_a_query=k1a, k1a_bound_s=bound, bound_by_chunks=by)
    return 100.0 * bound / k1a
