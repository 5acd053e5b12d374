"""Dataset substrate: deterministic synthetic stand-ins for the paper's 10
UCI datasets (numpy; see `synthetic`)."""
from repro_torch.datasets.synthetic import (
    DATASET_SPECS,
    Dataset,
    load_dataset,
    train_test_split,
    quantize_u8,
)

__all__ = [
    "DATASET_SPECS",
    "Dataset",
    "load_dataset",
    "train_test_split",
    "quantize_u8",
]
