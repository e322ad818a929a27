"""A roofline share of named kernels in the traced slice."""


def share(run, names) -> float | None:
    """100 x the kernels' bound over their device time, both for the
    launches one batch makes: each kernel's mean time a launch in the trace
    times its launches (so a dropped event does not shrink the sum).  None
    when a kernel is absent from the work or the trace."""
    if run.trace is None:
        return None
    kernels = run.work.get("kernels", {})
    bound = spent = 0.0
    for name in names:
        if name not in kernels:
            return None
        launches, bound_s = kernels[name]
        n, s = run.trace.kernel_time(name)
        if n == 0:
            return None
        bound += launches * bound_s
        spent += launches * s / n
    return 100.0 * bound / spent if spent > 0 else None
