"""The share of the profiled stretch in which nothing ran on the card:
1 - (union of device activity intervals / the stretch), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
