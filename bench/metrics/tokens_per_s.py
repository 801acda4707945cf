"""Every token of the steps completed in the window, over the time from
the window's start to the synchronise that ends its last step."""


def read(run):
    return run.rate("tokens")
