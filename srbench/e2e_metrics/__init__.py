"""End-to-end metric readers, one file per metric of ``BENCHMARK.json``'s
``end_to_end``, named as the metric.  Each defines ``read(window, cell)``:
the metric's value from a :class:`srbench.run.Window` on the host clock."""
