"""Device time a step of the events launched inside the program's
``uvc.optimizer`` span (the accumulation fold, the clip, AdamW, the frozen
updates' zeroing and the parameter add), in ms. The T2T-ViT training cells' reading, which moves
``t2t_train_img_s``."""

from uvcbench.spans import device_ms


def read(record):
    return device_ms(record, "uvc.optimizer")
