"""What the timed window drives: one file per receiver surface, found by
the ``driver`` name a configuration gives (``spec.driver``)."""
