"""The 95th percentile of every training iteration's time in the window
(linear between the closest ranks)."""

import statistics

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(record, setup_s):
    times = record.get("unit_s") or []
    if record["kind"] != "train" or len(times) < 2:
        return None
    return 1e3 * statistics.quantiles(times, n=20, method="inclusive")[18]
