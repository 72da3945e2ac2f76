"""One file per end-to-end metric, found by its name in ``BENCHMARK.json``:
``NAME``, ``UNIT`` and ``read(window)`` over the timed window's record
(``run.Window``), by the host's clock."""
