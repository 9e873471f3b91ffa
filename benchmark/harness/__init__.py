"""The benchmark's general machinery: the cell's files, the card, the
seeded inputs, the trace's arithmetic and the comparison that decides
``correct``."""
