"""Input rows of the calls completed in the window over the window's
seconds (host clock).  For a sort the rows sorted, for a query the
lineitem rows it scans."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(r.facts["rows"] for r in run.done) / run.window_s
