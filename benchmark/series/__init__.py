"""Seeded series generators, one module a generator, found by name."""
