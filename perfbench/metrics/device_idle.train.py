"""The device's idle share of the window's time a unit of work, in %: 1
minus the seconds in which a device operation ran in one more unit after
the window (the union of their intervals in the `torch.profiler` trace)
over the window's seconds a unit.  The profiler slows the host's side of
the traced unit, so its own span would count that cost as idle; the
window's time a unit has none of it.  The profiler can lose records on
the card's machine, so this is an upper bound."""
HOOKS = []


def read(run):
    prof = run.profile
    if not prof or prof["busy_s"] <= 0 or not run.units:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / (run.window_s / run.units))
