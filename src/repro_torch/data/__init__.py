"""Port of ``repro.data``: the molecule datasets, the SMILES tokenizer and
the LM token batch pipeline."""

from repro_torch.data.datasets import (
    DATASETS,
    DatasetStream,
    antioxidant_dataset,
    dataset_property_table,
    load_dataset,
    public_antioxidant_dataset,
    train_test_split,
    zinc_like_dataset,
)
from repro_torch.data.tokenizer import SmilesTokenizer
from repro_torch.data.pipeline import TokenBatcher, lm_batches_from_smiles

__all__ = [
    "DATASETS", "DatasetStream", "load_dataset", "antioxidant_dataset",
    "public_antioxidant_dataset", "zinc_like_dataset", "train_test_split",
    "dataset_property_table", "SmilesTokenizer", "TokenBatcher",
    "lm_batches_from_smiles",
]
