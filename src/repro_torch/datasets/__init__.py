"""Dataset substrate: deterministic synthetic stand-ins for the paper's 10
UCI datasets (numpy; see `synthetic`), and the paper's Tables I/II
(`paper_refs`), the sweep report's scoring targets."""
from repro_torch.datasets.synthetic import (
    DATASET_SPECS,
    Dataset,
    load_dataset,
    train_test_split,
    quantize_u8,
)
from repro_torch.datasets.paper_refs import (
    PAPER_MEAN_AREA_REDUCTION_1PCT,
    PAPER_MEAN_POWER_REDUCTION_1PCT,
    PAPER_TABLE1,
    PAPER_TABLE2_NORM,
)

__all__ = [
    "DATASET_SPECS",
    "Dataset",
    "load_dataset",
    "train_test_split",
    "quantize_u8",
    "PAPER_TABLE1",
    "PAPER_TABLE2_NORM",
    "PAPER_MEAN_AREA_REDUCTION_1PCT",
    "PAPER_MEAN_POWER_REDUCTION_1PCT",
]
