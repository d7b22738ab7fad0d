"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric.  Each defines ``read(source, cell)``:
the metric's value from the cell (:class:`srbench.cells.Cell`) and, for a
metric whose ``source`` is ``host_clock``, the run's
:class:`srbench.run.Window`, else a :class:`srbench.trace.Trace` of whole
calls (with the program's spans of those calls, :mod:`srbench.spans`); or
None where that holds nothing for it (the harness then leaves the metric
out)."""
