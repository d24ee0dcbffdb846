"""facl_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of facl_tpu.

Mirrors ``facl_tpu``'s layout module for module. The JAX package stays the
reference; this package imports nothing from it (nor jax, flax or optax).

Importing the package turns TF32 off for float32 matmuls and convolutions:
the SA stage's batch moments come from Gram-matrix identities whose
entries are O(rows), and a reduced-precision contraction there breaks
BatchNorm parity while every small CPU test still passes (docs/DESIGN.md
section 3 records the same failure under the TPU's default precision).
It also keeps bf16 GEMMs accumulating in f32 (cuBLAS may otherwise reduce
in bf16), as the JAX package's bf16 ``nn.Dense`` does.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Defaults to the card; raises
    when a CUDA device is asked for and none is present — the port never
    drops to the CPU on its own (tests pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "facl_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
