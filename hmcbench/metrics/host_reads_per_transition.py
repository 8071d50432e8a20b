"""Device-to-host reads and synchronisations the port made in the traced
call (the sum over sites of its ``host_reads``) per batch transition
(warmup and draws)."""


def read(run):
    counts = run.calls[0].launches
    if "host_reads" not in counts:
        return None
    transitions = counts["transitions_warmup"] + counts["transitions_draws"]
    if not transitions:
        return None
    return sum(counts["host_reads"].values()) / transitions
