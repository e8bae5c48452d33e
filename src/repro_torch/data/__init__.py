"""Port of ``repro.data``: the molecule datasets.  The SMILES tokenizer and
the LM input pipeline arrive with the backbone slice."""

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

__all__ = [
    "DATASETS", "DatasetStream", "load_dataset", "antioxidant_dataset",
    "public_antioxidant_dataset", "zinc_like_dataset", "train_test_split",
    "dataset_property_table",
]
