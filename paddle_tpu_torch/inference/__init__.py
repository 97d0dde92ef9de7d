from paddle_tpu_torch.inference.attention import (gather_paged_kv,
                                                  gather_paged_scales,
                                                  paged_attention_decode,
                                                  paged_attention_ragged,
                                                  ragged_attention_xla)
from paddle_tpu_torch.inference.engine import (GenerationEngine,
                                               GenerationRequest)
from paddle_tpu_torch.inference.fleet import (ElasticityPolicy,
                                              FleetSupervisor, RemoteHandle,
                                              RemoteServingHost)
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.inference.router import (FleetRouter, RouterHandle,
                                               ServingHost)
from paddle_tpu_torch.inference.server import (GenerationServer,
                                               RequestHandle)

__all__ = ["GenerationEngine", "GenerationRequest", "PagedKVCache",
           "gather_paged_kv", "gather_paged_scales", "paged_attention_decode",
           "paged_attention_ragged", "ragged_attention_xla",
           "GenerationServer", "RequestHandle", "FleetRouter", "RouterHandle",
           "ServingHost", "FleetSupervisor", "RemoteServingHost",
           "RemoteHandle", "ElasticityPolicy"]
