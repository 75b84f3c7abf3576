"""Hand-written CUDA kernels for Hopper, one wrapper module each, with the
plain PyTorch version of the same function beside every kernel."""
import torch


def needs_backward(*tensors) -> bool:
    """Whether autograd would need a backward through a function of
    `tensors`: grad is enabled and one of them requires it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def kernel_route(enabled: bool, *tensors) -> bool:
    """Whether a model's forward takes a kernel on `tensors`: the config
    asks for it (`use_pallas`) and no backward runs through it. A train
    step thus takes the kernels only where its forward is cut off from
    the loss's gradient (a frozen prefix that starts at a frozen
    embedding), and the plain path everywhere else."""
    return enabled and not needs_backward(*tensors)


def forward_only(name: str, *tensors) -> None:
    """Raise where autograd would need a backward: the kernels have none,
    and a CUDA kernel's output carries no `grad_fn`, so the gradient would
    be dropped without a word. The check is the same on every device, so
    the CPU route, which runs the plain version, refuses the same calls.
    Raise too on a DTensor, which has no data pointer for a kernel: a
    sharded step hands the kernels each rank's local shards."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes a rank's local tensors, not a "
                        f"DTensor (its kernel reads a data pointer)")
    if needs_backward(*tensors):
        raise RuntimeError(
            f"{name} is forward-only (its kernel has no backward): call it "
            f"under torch.no_grad() or torch.inference_mode(), or on inputs "
            f"that do not require grad")
