"""Step builders and input stand-ins (the port of ``src/repro/launch/``,
one-device half)."""
