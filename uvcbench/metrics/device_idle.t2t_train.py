"""The device's idle share of the traced stretch: 1 - the union of the
device events' intervals over the span from the first event's start to
the last one's end, in %.  The T2T-ViT training cells' reading, which
moves ``t2t_train_img_s``."""


def read(record):
    if record["kind"] != "train" or "trace" not in record:
        return None
    tr = record["trace"]
    if tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
