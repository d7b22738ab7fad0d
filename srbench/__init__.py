"""The benchmark of the PyTorch + CUDA port,
``enph459_super_resolution_tpu_torch``: calls of the port on one H100,
back to back, each through the runner its cell's configuration names
(``runners/``: ``classical``, the default, sends whole classical SR
sessions; another runner is a file beside it, with its own reference and
tests).

``BENCHMARK.json`` at the root names the cells; each is a configuration
(``configs/``) under a traffic mix (``traffic/``), driven by the runner
the configuration names (``runners/``), checked against the limits
``limits/<cell>.json``, and reports the metrics whose readers are
``e2e_metrics/`` and ``layer_metrics/``.  ``run`` drives one run,
``calibrate`` takes the readings the limits are set from, ``reference`` is
the classical runner's plain reference, ``generator`` makes its inputs, ``work`` counts the
work the rooflines divide, ``trace`` reads the profiler, ``spans`` puts
device time down to the program's spans.  Nothing here imports
JAX or the JAX package.
"""
