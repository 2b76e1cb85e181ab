"""Percent of the profiled compresses' y symbols that escaped their
mixture rows into the coder's side list, from the program's
``GMM_STATS``."""


def read(run):
    stats = run.get("gmm_stats")
    if not stats or not stats.get("symbols"):
        return None
    return 100.0 * stats["escapes"] / stats["symbols"]
