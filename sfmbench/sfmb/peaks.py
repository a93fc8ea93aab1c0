"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): the yardstick of every roofline and mfu share."""

FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}
BYTES_PER_S = 3.35e12


def least_s(flops, nbytes, precision):
    """The least time the chip could take: the larger of the operations
    over the precision's peak and the bytes over the memory bandwidth."""
    return max(flops / FLOPS[precision], nbytes / BYTES_PER_S)
