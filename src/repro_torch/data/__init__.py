"""Token data of the port: the synthetic LM corpus (`pipeline`)."""
from repro_torch.data.pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
