"""Microseconds of host time to issue one lockstep leaf of the plain
driver over the traced call's draws: the port's ``dhmc.leaf`` span
aggregate in the draws phase (the leaf's hook call and the driver's
bookkeeping up to the next ``leaf_loop`` read, the read itself left out),
its nanoseconds over its count. Where the launch queue is full it holds
the back-pressure, and then reads the device's pace."""


def read(run):
    spans = run.calls[0].launches.get("spans") or {}
    leaf = spans.get("dhmc.leaf", {}).get("draws")
    if not leaf or not leaf["count"]:
        return None
    return leaf["ns"] / leaf["count"] / 1e3
