"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's units (the benchmark's own count, ``flops.forward_flops``)
over the window and 989 TFLOP/s, in %."""

from uvcbench.flops import PEAK_BF16_FLOPS


def read(record):
    if record["kind"] != "serve":
        return None
    return 100.0 * record["flops_per_unit"] * record["units"] \
        / record["window_s"] / PEAK_BF16_FLOPS
