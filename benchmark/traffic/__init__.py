"""One runner a traffic kind: ``<kind>.py`` with ``run(cell, seed, seconds,
trace, t_start, device="cuda") -> dict``."""
