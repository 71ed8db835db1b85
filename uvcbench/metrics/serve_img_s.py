"""Images served a second: every image whose ids reached the host in the
window over the window."""


def read(record):
    if record["kind"] != "serve":
        return None
    return record["images"] / record["window_s"]
