"""Hand-written Hopper kernels of the port, one package per TPU kernel
package of ``src/repro/kernels``: ``store`` (probe / gather) and
``quadconv``.  Each keeps ``csrc/`` (CUDA C++), ``ref.py`` (plain PyTorch)
and ``ops.py`` (device-dispatching wrapper); ``_build.py`` compiles and
binds the sources.  Attention and SSD are still to port (``ROADMAP.md``
queue B)."""
