"""Argument checks shared by the kernel wrappers: a kernel takes only what
it was written for and the wrapper raises on anything else."""

import torch

__all__ = ["check_cuda_f32", "check_cuda", "check_seed_tensor",
           "raise_on_error"]


def check_cuda_f32(kernel, device, contiguous=True, **tensors):
    """Each tensor is float32, on ``device`` (a CUDA device) and, with
    ``contiguous``, dense; raises ValueError naming the first that is
    not."""
    check_cuda(kernel, device, (torch.float32,), contiguous, **tensors)


def check_cuda(kernel, device, dtypes, contiguous=True, **tensors):
    """As ``check_cuda_f32``, each tensor's dtype one of ``dtypes``: the
    dtypes the kernel has an instantiation for (a bf16 one where it has
    one); any other raises."""
    if device.type != "cuda":
        raise ValueError("%s kernel: tensors are on %s, not a CUDA device"
                         % (kernel, device))
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError("%s kernel: %s is on %s, want %s"
                             % (kernel, name, t.device, device))
        if t.dtype not in dtypes:
            raise ValueError("%s kernel: %s is %s, wants %s"
                             % (kernel, name, t.dtype, " or ".join(
                                 str(d).replace("torch.", "")
                                 for d in dtypes)))
        if contiguous and not t.is_contiguous():
            raise ValueError("%s kernel: %s is not contiguous"
                             % (kernel, name))


def check_seed_tensor(kernel, name, t, device):
    """``t`` is a dense int32 [2] on ``device``: an op's Seed, which a
    kernel writes (forward) or reads (backward) on the card."""
    if not isinstance(t, torch.Tensor) or t.device != device \
            or t.dtype != torch.int32 or t.numel() != 2 \
            or not t.is_contiguous():
        raise ValueError("%s kernel: %s must be a dense int32 [2] tensor on "
                         "%s (the op's Seed)" % (kernel, name, device))


def raise_on_error(kernel, err):
    if err != 0:
        raise RuntimeError("%s kernel launch failed: cudaError_t %d"
                           % (kernel, err))
