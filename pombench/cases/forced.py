"""extPOM's forced regional domain: POM's seamount grid, bathymetry and
initial fields (``cases/seamount.py``) with an island and a stretch of
coast, a climatology of its own and every forcing series of
bounds_forcing.f at its record period, made from the seed as
``tests/forced_case.py`` makes them (``assumed.forcing``: the records of
each dataset, whether ``taurstr`` is given, the island and the coast)."""

from pombench.tests.forced_case import make  # noqa: F401
