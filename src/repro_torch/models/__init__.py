"""The LM stack of the port, for the `attn_mlp` layer kind (families
`dense`, `audio` and `vlm`), the `attn_moe` kind (family `moe`) and the
`ssm` kind (families `ssm` and `hybrid`): norms and RoPE (`common`),
attention with the `flash_attention` kernel on prefill (`attention`), the
feed-forward block (`lm_mlp`), the Mixture-of-Experts block (`moe`), the
Mamba2 layer (`ssm`), the layer stack (`transformer`) and the serving
steps and caches (`lm`). Every kind also trains on a rank of a mesh: the
blocks' `*_sharded` forms under `transformer.forward_train(...,
rules=)`."""
from repro_torch.models import (attention, common, lm, lm_mlp, moe, ssm,
                                transformer)

__all__ = ["attention", "common", "lm", "lm_mlp", "moe", "ssm", "transformer"]
