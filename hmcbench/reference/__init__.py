"""The yardstick: plain torch and numpy, importing nothing of the port.

Each model kind is a module of its own (``<model>.py``, the ``model`` key
of a configuration file): its data from the configuration, its log density
and gradient in float64 (the reference) or at TF32 precision (the
control), its posterior's mean and covariance (exact, or by
``importance`` sampling), and the operations and bytes of one leaf and one
tree-kernel launch. ``ess`` is the bulk ESS, ``peaks`` the H100's
published peaks and the roofline bound, ``precision`` the rounding of the
control.
"""
