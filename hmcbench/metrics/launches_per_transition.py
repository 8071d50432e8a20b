"""Device kernels the profiler recorded in the traced call (copies and
fills left out) per launch of the tree kernel (the port's launch count)."""

COPIES = ("Memcpy", "Memset")


def read(run):
    launches = run.calls[0].launches.get("tree_transition", 0)
    if run.trace is None or not launches:
        return None
    kernels = [e for e in run.trace.device if not e[0].startswith(COPIES)]
    return len(kernels) / launches
