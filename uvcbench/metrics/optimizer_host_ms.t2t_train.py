"""The host's time a step inside the program's ``uvc.optimizer`` span, in
ms. The T2T-ViT training cells' reading, which moves
``t2t_train_img_s``."""

from uvcbench.spans import host_ms


def read(record):
    return host_ms(record, "uvc.optimizer")
