"""Traffic kinds: one module each, found by the kind a workload file names.
Each module has a ``Traffic`` class built from a :class:`gpubench.cell.Context`
(see ``gpubench/cell.py`` for the methods the harness calls)."""
