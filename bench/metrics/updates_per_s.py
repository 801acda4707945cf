"""Every machine update flushed into the served theta in the window, over
the time from the window's start to the synchronise that ends its last
round (host clock; in a traced run the profiler's host events slow the
host-paced rounds, so it reads the traced window's rate)."""


def read(run):
    return run.rate("updates")
