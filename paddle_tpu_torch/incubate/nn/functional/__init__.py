from paddle_tpu_torch.incubate.nn.functional.fused_ops import (
    flash_attention_impl, fused_block, fused_block_enabled, fused_rms_norm,
    fused_rotary_position_embedding, swiglu)

__all__ = ["fused_rms_norm", "fused_rotary_position_embedding", "swiglu",
           "flash_attention_impl", "fused_block", "fused_block_enabled"]
