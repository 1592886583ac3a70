from scrabblegan.kernels.attention import (
    nonlocal_attention,
    reference_attention,
    triton_attention,
)

__all__ = ["nonlocal_attention", "reference_attention", "triton_attention"]
