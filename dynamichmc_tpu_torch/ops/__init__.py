"""Hand-written GPU kernels of the port (built at first use, never at
import)."""
