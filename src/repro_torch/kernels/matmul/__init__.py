"""The DLA instruction ``activation(x @ w + bias)`` as a hand-written CUDA
kernel (``csrc/matmul.cu``), beside its plain version."""

from repro_torch.kernels.matmul.ops import MATMUL, PLAIN_CALLS, matmul
from repro_torch.kernels.matmul.ref import (
    ACTIVATIONS,
    apply_activation,
    matmul_plain,
)

__all__ = ["ACTIVATIONS", "MATMUL", "PLAIN_CALLS", "apply_activation",
           "matmul", "matmul_plain"]
