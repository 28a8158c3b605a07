"""Hand-written Hopper kernels and their plain PyTorch versions."""


def use_kernel(impl, x) -> bool:
    """The ops' ``impl`` rule: ``None`` takes the kernel for a CUDA tensor
    and the plain version for a CPU one; ``"reference"`` takes the plain
    version on any device; ``"cuda"`` takes the kernel and raises for a CPU
    tensor."""
    if impl is None:
        return x.is_cuda
    if impl == "reference":
        return False
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return True
    raise ValueError(f"unknown impl {impl!r}: None, 'cuda' or 'reference'")
