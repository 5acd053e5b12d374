"""Token data of the port: the synthetic LM corpus (`pipeline`)."""
from repro_torch.data.pipeline import SyntheticLMData, make_batch_specs

__all__ = ["SyntheticLMData", "make_batch_specs"]
