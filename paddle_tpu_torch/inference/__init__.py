from paddle_tpu_torch.inference.attention import (gather_paged_kv,
                                                  gather_paged_scales,
                                                  paged_attention_decode,
                                                  paged_attention_ragged,
                                                  ragged_attention_xla)
from paddle_tpu_torch.inference.engine import (GenerationEngine,
                                               GenerationRequest)
from paddle_tpu_torch.inference.paged_cache import PagedKVCache

__all__ = ["GenerationEngine", "GenerationRequest", "PagedKVCache",
           "gather_paged_kv", "gather_paged_scales", "paged_attention_decode",
           "paged_attention_ragged", "ragged_attention_xla"]
