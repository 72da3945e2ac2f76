"""One file per per-layer metric, found by its name in ``BENCHMARK.json``.

Each file holds ``NAME``, ``UNIT``, ``LAYER``, ``PATTERNS`` (the kernel
name patterns, ``fnmatch`` on the bare function name, that the layer
owns; device time no metric's patterns claim is the step's glue) and
``read(view)``: the value from a ``trace.TraceView``, or None where the
trace holds nothing for it to read.
"""
