"""The benchmark's own code: what it reads from ``BENCHMARK.json`` and the
files named there, the traffic generator, the drivers that run a cell, the
reduction of spans, counters and traces to metrics, and the comparison
that decides ``correct``.  Nothing here imports JAX or the JAX package;
the port is imported only by the drivers, at run time."""
