"""Percent of the traced call's tree-kernel launches (the port's
``tree_transition``) that took the logistic-regression leaf's staged-X
variant (``tree_transition_xstaged``: X staged once per CTA); the rest ran
the CTA or the warp variant."""


def read(run):
    counts = run.calls[0].launches
    launches = counts.get("tree_transition", 0)
    if "tree_transition_xstaged" not in counts or not launches:
        return None
    return 100.0 * counts["tree_transition_xstaged"] / launches
