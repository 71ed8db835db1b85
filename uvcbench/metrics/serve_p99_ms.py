"""The 99th percentile over every batch of the window of the time from a
batch's issue to its class ids on the host, in ms."""

import statistics


def read(record):
    if record["kind"] != "serve" or len(record["latencies_s"]) < 100:
        return None
    return statistics.quantiles(record["latencies_s"], n=100)[98] * 1e3
