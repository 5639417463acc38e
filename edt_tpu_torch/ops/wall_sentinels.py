"""Wall-count sentinel values (counterpart of ``edt_tpu.ops.wall_sentinels``).

Wall fields reach the walled argmin kernel (K2) as integer COUNTS: the
distance in voxels to the nearest label-boundary wall
(``models.soft._wall_counts``). A count at or above the sentinel means
"open side" and reads as an INF wall. The sentinel must exceed any real
count (n + 1), which is why int16 counts require n <= 16000.
"""

WALL_SENT16 = 30000
WALL_SENT32 = 1 << 30
