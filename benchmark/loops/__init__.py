"""Traffic loops, one module a loop kind, found by a mix's ``loop``."""
