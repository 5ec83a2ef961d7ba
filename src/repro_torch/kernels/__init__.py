"""GR-MAC kernel subsystem of the port.

    ops.cim_matmul        model-facing op (pre-scale, mode switch, STE
                          gradients); what ``models.layers`` calls
    dispatch.grmac_matmul K padding + the kernel for CUDA tensors, the
                          plain version for CPU tensors
    grmac_matmul.py       build, binding and launch of the hand-written
                          Hopper kernel ``csrc/grmac_matmul.cu``
    ref.py                the plain PyTorch version (the oracle)
"""
from repro_torch.kernels.dispatch import BACKENDS, grmac_matmul, resolve_backend
from repro_torch.kernels.ops import cim_matmul

__all__ = ["BACKENDS", "cim_matmul", "grmac_matmul", "resolve_backend"]
