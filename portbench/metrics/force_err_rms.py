"""force_err_rms: RMS relative force error at the sampled targets against
the float64 direct sum, of the window's last output (the step cell: of
the step's configuration queried on the window's last state)."""


def read(run):
    return run.diagnostics.get("force_err_rms")
