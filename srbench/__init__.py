"""The benchmark of the PyTorch + CUDA port,
``enph459_super_resolution_tpu_torch``: back-to-back classical SR
sessions on one H100.

``BENCHMARK.json`` at the root names the cells; each is a configuration
(``configs/``) under a traffic mix (``traffic/``), driven by the runner
the configuration names (``runners/``), checked against the limits
``limits/<cell>.json``, and reports the metrics whose readers are
``e2e_metrics/`` and ``layer_metrics/``.  ``run`` drives one run,
``calibrate`` takes the readings the limits are set from, ``reference`` is
the plain reference, ``generator`` makes the inputs, ``work`` counts the
work the rooflines divide, ``trace`` reads the profiler, ``spans`` puts
device time down to the program's spans.  Nothing here imports
JAX or the JAX package.
"""
