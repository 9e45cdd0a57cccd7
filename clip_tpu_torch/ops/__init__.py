"""Kernel wrappers, their plain PyTorch versions, and the reference math."""

from .actquant import (actq, gemm_gq, gemm_i8, lnq, mlp_gq, mlp_lnq, mlp_lnq_stream, requant,
                       w8a8_pre)
from .attention import (attention_heads, attn_block, attn_block_stream, layer_block, mha,
                        mha_qkv, mha_qkv_i8)
from .qmatmul import qmatmul_q4, qmatmul_q5, qmatmul_q8

#: every wrapper that launches a CUDA kernel; each counts in ``.launches``
WRAPPERS = (attn_block, mlp_lnq, qmatmul_q4, qmatmul_q5, qmatmul_q8, mha_qkv, lnq, gemm_gq,
            mlp_gq, mha_qkv_i8, w8a8_pre, gemm_i8, requant, attention_heads,
            attn_block_stream, mlp_lnq_stream, actq, layer_block, mha)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
