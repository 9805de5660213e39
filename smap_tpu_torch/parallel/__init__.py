"""Data parallelism: process groups and collectives (``distributed``),
and the devices of single-process sharded serving (``mesh``)."""
