"""Constants of ``extpom_tpu/mesh/padding.py`` the decomposed step reads.
Padding ragged grids up to the mesh is not ported yet: a grid that does
not divide the mesh raises (``mesh/shardmap.py``)."""

# grid metrics that sit in denominators: rings beyond the physical domain
# hold 1 so that the arithmetic there stays finite (the values are never
# committed)
_GRID_PAD_ONE = frozenset({"dx", "dy", "h", "art", "aru", "arv"})
# which horizontal axis each per-side forcing series follows
FORCING_J_SERIES = frozenset({"elw", "ele", "uabw", "uabe", "vabw", "vabe",
                              "tbw", "tbe", "sbw", "sbe", "ubw", "ube",
                              "vbw", "vbe"})
FORCING_I_SERIES = frozenset({"els", "eln", "vabs", "vabn", "uabs", "uabn",
                              "tbs", "tbn", "sbs", "sbn", "vbs", "vbn",
                              "ubs", "ubn"})
