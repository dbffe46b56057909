"""qnmfits_tpu_torch: the PyTorch/CUDA port of qnmfits_tpu.

Each module is named after the qnmfits_tpu module it ports, which stays
the reference the port is tested against.  This slice ports the t0 x
mode-set sweep (``mismatch_t0_mode_sets``) for a scalar remnant with
'geq' windows; its batched Hermitian solve runs in a hand-written FP64
CUDA kernel (``ops/chol_cuda.py``, ``csrc/chol_solve.cu``).

Device and dtype policy:

* entry points take ``device=``, default ``"cuda"``; without CUDA they
  raise unless the caller asks for ``device="cpu"`` -- never a silent
  fallback;
* every tensor is float64 or complex128, created with an explicit dtype
  (torch's default dtype is float32).
"""

import torch

RDTYPE = torch.float64
CDTYPE = torch.complex128


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point; raises when CUDA is asked
    for (the default) and unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qnmfits_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


from .fitting import mismatch_t0_mode_sets  # noqa: E402

__all__ = ["CDTYPE", "RDTYPE", "mismatch_t0_mode_sets", "resolve_device"]
