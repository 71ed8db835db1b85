"""Images trained a second: every image of the steps finished in the
window over the window, which ends in a synchronise."""


def read(record):
    if record["kind"] != "train":
        return None
    return record["images"] / record["window_s"]
