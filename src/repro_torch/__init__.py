"""Ranky distributed SVD on large sparse matrices, in PyTorch + CUDA.

The counterpart of the JAX package ``repro``: same module and function
names where that helps a reader find the counterpart, plain functions on
tensors inside.  It imports ``torch`` and nothing of ``repro`` or JAX.

Numeric policy of the whole package: float32 on the solve path, int32
indices in the containers and kernels (converted to int64 only at a
torch indexing call), and TF32 switched OFF for matrix products and for
cuDNN.  The grams feed ``eigh`` and then ``sqrt`` (``core/svd.py:
eigh_to_svd``), so a 10-bit mantissa in G would show up directly in the
small singular values.  The matmul flag is PyTorch's default and the cuDNN
flag is not (PyTorch lets cuDNN use TF32 by default); both are pinned here
because other code in the process may switch them.  The LM path
(``models/``, ``serve/engine.py``) computes in its config's dtype
(bfloat16 for the published configs) from float32 master weights cast at
each use, with float32 norms, softmax, scan state and logits, as the
reference does; a float32 config computes in float32 throughout.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    GPU.  ``None`` never means the CPU: it raises when no CUDA device is
    present, so that a solve cannot end up on the host unnoticed."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given; "
                "pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            f"available")
    return device
