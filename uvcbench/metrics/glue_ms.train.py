"""Device time a step of every event outside the port's kernels (those of
the ``uvc::`` namespace): AdamW, the minimax update, the losses, mixup,
PyTorch's elementwise work and copies, in ms."""


def read(record):
    if record["kind"] != "train" or "trace" not in record \
            or not record["trace"]["events"]:
        return None
    tr = record["trace"]
    return 1e3 * sum(e["dur_s"] for e in tr["events"]
                     if "uvc::" not in e["name"]) / tr["units"]
