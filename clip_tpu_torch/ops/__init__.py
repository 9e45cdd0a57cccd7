"""Kernel wrappers, their plain PyTorch versions, and the reference math."""

from .actquant import gemm_i8, lnq, mlp_lnq, requant
from .attention import attention_heads, attn_block
from .qmatmul import qmatmul_q4

#: every wrapper that launches a CUDA kernel; each counts in ``.launches``
WRAPPERS = (attn_block, mlp_lnq, qmatmul_q4, lnq, gemm_i8, requant, attention_heads)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
