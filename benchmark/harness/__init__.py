"""The benchmark's general code: finding files by name, the seeded data,
one run of a cell, trace reading, the operation and byte counts, and the
comparisons that decide ``correct``."""
