"""Microseconds of host time to issue one warmup transition in the traced
call: the port's ``dhmc.transition`` span aggregate in the warmup phase,
its nanoseconds over its count. Where the launch queue is full it holds
the back-pressure, and then reads the device's pace."""


def read(run):
    spans = run.calls[0].launches.get("spans") or {}
    step = spans.get("dhmc.transition", {}).get("warmup")
    if not step or not step["count"]:
        return None
    return step["ns"] / step["count"] / 1e3
