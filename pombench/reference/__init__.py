"""The plain reference that decides ``correct``: one internal step of the
mode-split model, its grid, cold start, edge data and diagnostics in plain
PyTorch, written without the port's code.

``kernels.py`` vectorises, one function each, the loop functions of
``pombench/tests/pom_ref.py``: a frozen copy of the repository's NumPy
oracle ``tests/reference/pom_ref.py``, written from POM's solver.f with one
loop per sum.  ``model.py`` composes them as POM's advance.f does.  It
imports nothing of the port or of the JAX package, and computes in any
float dtype: the configuration's, and the one below it for the control.
"""
