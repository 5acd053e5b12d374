"""The LM stack of the port, for the `attn_mlp` layer kind (families
`dense`, `audio` and `vlm`): norms and RoPE (`common`), attention with the
`flash_attention` kernel on prefill (`attention`), the feed-forward block
(`lm_mlp`), the layer stack (`transformer`) and the serving steps and caches
(`lm`). MoE, SSM and hybrid layers are a later slice of the port."""
from repro_torch.models import attention, common, lm, lm_mlp, transformer

__all__ = ["attention", "common", "lm", "lm_mlp", "transformer"]
