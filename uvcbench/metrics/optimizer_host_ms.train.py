"""The host's time a step inside the program's ``uvc.optimizer`` span, in
ms."""

from uvcbench.spans import host_ms


def read(record):
    return host_ms(record, "uvc.optimizer")
