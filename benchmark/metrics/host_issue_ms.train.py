"""Mean host ms from the call of `Engine.train_step` to its return, with no
synchronise: how long the host takes to issue a step (against the step's
time, how far ahead of the card it can run)."""

from statistics import fmean


def read(ctx):
    issue = ctx["window"].get("issue_s")
    return 1e3 * fmean(issue) if issue else None
