"""The 95th percentile (ms), over every round of the window, of a round's
time from its ``submit_many`` call to the synchronise that ends its flush
(host clock)."""
from bench.lib.stats import percentile


def read(run):
    times = [s["round_s"] for s in run.steps if "round_s" in s]
    if not times:
        return None
    return 1e3 * percentile(times, 95)
