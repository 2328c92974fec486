"""Per-layer metric readers, one module a metric, found by the metric's
name (``<name>.py``).  Each ``read(ctx)`` returns a number, or None where
it finds nothing to read; ``_shared.py`` holds what they share."""
