"""Hand-written Hopper kernels of the port, each beside its plain version."""

#: every kernel of the port, by the name of its ``<name>/csrc/<name>.cu``
KERNEL_NAMES = ("flash_attention", "ssd", "cc_matmul", "matmul")
