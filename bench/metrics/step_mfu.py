"""The whole training step's share of the card's bf16 peak (%): 6 N D
over (seconds per step x 989e12), N the configuration's parameters, D
the step's tokens, the seconds the traced window's over its steps."""
from bench.lib.roofline import mfu


def read(run):
    if run.trace is None or not run.steps:
        return None
    per_step = run.trace.window_us / 1e6 / len(run.steps)
    return 100.0 * mfu(run.cell.n_params, run.cell.tokens_per_step,
                       per_step)
