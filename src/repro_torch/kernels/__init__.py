"""Hand-written CUDA kernels of the port, each beside its plain version."""


def check_tma(tensors) -> None:
    """Raise unless TMA can address each ``(name, tensor)``: a 16-byte
    aligned base, and strides of 16 bytes' multiples along every dim but
    the last (contiguous) that is longer than 1.  The kernels that read
    with TMA (``csrc/tma.cuh``) check their tensors before a launch, so
    nothing falls back."""
    for name, x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}'s base address is not 16-byte aligned")
        for d in range(x.ndim - 1):
            if x.shape[d] > 1 and (x.stride(d) * x.element_size()) % 16:
                raise ValueError(f"{name}'s stride {x.stride(d)} along dim "
                                 f"{d} is not a multiple of 16 bytes")


def tma_able(x) -> bool:
    """Whether a TMA kernel can read ``x`` as it is: N contiguous, and
    :func:`check_tma`'s base and strides, each stride of a dim longer than
    1 positive (an expanded gradient's stride 0 is not)."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(x.shape[d] <= 1 or (x.stride(d) > 0 and (
                x.stride(d) * x.element_size()) % 16 == 0)
                for d in range(x.ndim - 1)))
