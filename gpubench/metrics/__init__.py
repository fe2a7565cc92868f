"""Per-layer metric readers: ``read(reading, name) -> float | None``, one
module a metric (or a metric's name before its first dot). ``reading``
holds the traced ``window`` (:class:`gpubench.trace.Window`), the program's
``counters`` over the window, ``window_s``, the configuration ``cfg``, the
workload ``cell`` and what the traffic counted (``units``, ``users``,
``steps``, ``examples``, ``flops``, ``route``). A reader that finds
nothing to read returns ``None``, and the metric is left out of the line."""
