"""The MLP sublayer's kernels' share of their roofline
(``spans.sublayer_roofline`` over the wrappers ``spans.MLP``), in %. The T2T-ViT training cells' reading, which moves
``t2t_train_img_s``."""

from uvcbench.spans import MLP, sublayer_roofline


def read(record):
    return sublayer_roofline(record, "train", MLP)
