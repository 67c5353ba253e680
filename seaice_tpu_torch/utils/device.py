"""Where tensors go when the caller names no device."""

import os

import torch
import torch.distributed as dist


def resolve_device(device) -> torch.device:
    """device=None means the GPU, and raises where there is none: nothing
    in the package moves to the CPU on its own.  Ask for "cpu" to get
    it.  Under an initialised process group launched one process per
    card (`torch.distributed.run` sets LOCAL_RANK) the GPU is the rank's
    own card, cuda:LOCAL_RANK; otherwise the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the CPU")
        local = os.environ.get("LOCAL_RANK")
        if local is not None and dist.is_available() and \
                dist.is_initialized():
            return torch.device("cuda", int(local))
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
