"""Hand-written Hopper kernels of the port, one package per TPU kernel
package of ``src/repro/kernels``: ``store`` (probe / sample / gather),
``quadconv``, ``attention`` (the flash forward) and ``ssd`` (the
intra-chunk step).  Each keeps ``csrc/`` (CUDA C++), ``ref.py`` (plain
PyTorch) and ``ops.py`` (device-dispatching wrapper); ``_build.py``
compiles and binds the sources.  Still to port: ``gather_sharded`` and
the flash backward (``ROADMAP.md`` queue B)."""
