"""Structured errors with debug payloads (port of ``dynamichmc_tpu.errors``).

An exception that carries a message plus named debug values (positions,
stepsizes, chain indices, ...). Raised only from host-side checks; inside a
transition numerical faults are handled by -inf poisoning, never by
exceptions (see hamiltonian.py).
"""

from __future__ import annotations


class DynamicHMCError(RuntimeError):
    """Error with a message and an arbitrary payload of debug values."""

    def __init__(self, message: str, **payload):
        self.message = message
        self.payload = payload
        super().__init__(message)

    def __str__(self) -> str:
        lines = [self.message]
        for key, value in self.payload.items():
            lines.append(f"  {key} = {value!r}")
        return "\n".join(lines)
