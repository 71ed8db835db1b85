"""Device time a step of the events launched inside the program's
``uvc.arch_update`` span (the minimax architecture update: the prox, the
group scores, the resource, the primal and dual steps, and the backward of
its own gradients, which carries the span on the autograd engine's thread
too), in ms."""

from uvcbench.spans import device_ms


def read(record):
    return device_ms(record, "uvc.arch_update")
