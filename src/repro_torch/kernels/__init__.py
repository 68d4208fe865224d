"""Hand-written Hopper kernels of the port, each beside its plain version."""

#: every kernel library of the port, by the name of its source
#: (``common.source_of``: ``<name>/csrc/<name>.cu``, ``<dir>/<name>`` for
#: ``<dir>/csrc/<name>.cu``)
KERNEL_NAMES = ("flash_attention", "ssd", "ssd/ssd_bwd", "cc_matmul",
                "matmul")
