"""The attention sublayer's kernels' share of their roofline
(``spans.sublayer_roofline`` over the wrappers ``spans.ATTENTION``), in %. The T2T-ViT training cells' reading, which moves
``t2t_train_img_s``."""

from uvcbench.spans import ATTENTION, sublayer_roofline


def read(record):
    return sublayer_roofline(record, "train", ATTENTION)
