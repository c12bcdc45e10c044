"""Data parallelism: ``mesh`` (one process's devices, a process group's
ranks) and ``launch`` (start a host's ranks as ``torchrun`` does)."""
