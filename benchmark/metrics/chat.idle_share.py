"""The share of the traced slice of the window with no operation on the
device."""


def read(run):
    w = run.tracer.window_s
    if not w or not run.tracer.kernels:
        return None
    return 100.0 * (1.0 - run.tracer.busy_s() / w)
