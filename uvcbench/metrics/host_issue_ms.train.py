"""The host's time from the call into the entry to its return, before any
synchronise, in ms: the mean over the traced stretch's units.  Where the
card paces the loop, the call waits on the full launch queue, and this
reads near a unit's device time."""


def read(record):
    if record["kind"] != "train" or "trace" not in record:
        return None
    issue = record["trace"]["issue_s"]
    return sum(issue) / len(issue) * 1e3
