"""Device events (kernels, copies, memsets) of the traced stretch, a
unit.  The T2T-ViT training cells' reading, which moves
``t2t_train_img_s``."""


def read(record):
    if record["kind"] != "train" or "trace" not in record \
            or not record["trace"]["events"]:
        return None
    tr = record["trace"]
    return len(tr["events"]) / tr["units"]
