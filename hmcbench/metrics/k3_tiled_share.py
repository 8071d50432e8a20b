"""Percent of the traced call's fused logreg leaf launches (the port's
``logreg_fused_leaf``, K3) that took the tiled slice kernel
(``logreg_fused_leaf_tiled``: every logit once per staged tile of X, the
whole gradient from the same staging); the rest ran the chunked one."""


def read(run):
    counts = run.calls[0].launches
    launches = counts.get("logreg_fused_leaf", 0)
    if "logreg_fused_leaf_tiled" not in counts or not launches:
        return None
    return 100.0 * counts["logreg_fused_leaf_tiled"] / launches
