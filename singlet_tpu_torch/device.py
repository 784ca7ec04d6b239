"""Device and precision policy of the PyTorch port.

Counterpart of ``singlet_tpu/utils.py`` for what the port needs. The
JAX package runs every f32 product at ``Precision.HIGHEST``
(``singlet_tpu/ops/linalg.py:29-33``) because the CD-NNLS recurrence
diverges under single-pass bf16; the port therefore turns TF32 off for
matmuls and convolutions and keeps float32 products at "highest".
"""

from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """Full-f32 products: TF32 off (matmul and cuDNN), "highest" precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The fit's device; ``None`` means ``"cuda"``.

    Asking for CUDA without a card raises: the port never carries on
    silently on the CPU. Also applies the precision policy.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    set_precision_policy()
    return dev


def is_scipy_sparse(A) -> bool:
    """True when A is a scipy sparse matrix (False when scipy is absent)."""
    try:
        import scipy.sparse as sp

        return sp.issparse(A)
    except ImportError:
        return False


def vprint(verbose: int, level: int, *args) -> None:
    """Print when ``verbose >= level`` (a copy of ``singlet_tpu.utils``)."""
    if verbose >= level:
        print(*args, flush=True)
