from .ops import attention_reference, flash_attention
from .ref import attention_ref, blockwise_ref

__all__ = ["attention_ref", "attention_reference", "blockwise_ref",
           "flash_attention"]
