"""ops_ms.evals: device milliseconds a query of every operation that is
not one of the port's own CUDA kernels (the walk's, far field's and
assembly's torch operations, copies and fills), from the trace."""

from portbench.trace import is_port_kernel


def read(run):
    if run.trace is None or not run.calls or not run.trace.dev_names:
        return None
    return 1e3 * run.trace.op_seconds(
        lambda n: not is_port_kernel(n)) / run.calls
