"""Constants the port shares with the reference's ``const.py``.

SLO tier names: latency-critical requests admit ahead of best-effort ones.
Copies, not imports: the port imports nothing of the reference package.
"""

SLO_TIER_CRITICAL = "critical"
SLO_TIER_BEST_EFFORT = "best_effort"
