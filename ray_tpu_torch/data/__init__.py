"""ray_tpu_torch.data: distributed datasets on the object store.

Analog of the reference's python/ray/data: blocks are pyarrow tables in
the object store; transforms run as tasks/actor pools; the default batch
format is numpy dicts, and ``iter_torch_batches`` / ``Dataset.split`` feed
each rank's shard to a TorchTrainer loop as tensors on its device.
"""

from ray_tpu_torch.data import aggregate
from ray_tpu_torch.data._internal.compute import (ActorPoolStrategy,
                                            TaskPoolStrategy)
from ray_tpu_torch.data.aggregate import (AggregateFn, Count, Max, Mean, Min, Std,
                                    Sum)
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.dataset import Dataset, GroupedDataset
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
from ray_tpu_torch.data.preprocessors import (BatchMapper, Chain, Concatenator,
                                        LabelEncoder, MinMaxScaler,
                                        OneHotEncoder, Preprocessor,
                                        SimpleImputer, StandardScaler)
from ray_tpu_torch.data.read_api import (from_arrow, from_items,
                                   from_numpy, from_pandas, from_torch, range,
                                   range_tensor, read_binary_files, read_csv,
                                   read_datasource, read_images, read_json,
                                   read_numpy, read_parquet, read_text,
                                   read_tfrecords)

__all__ = [
    "ActorPoolStrategy", "AggregateFn", "BatchMapper", "Block",
    "BlockAccessor", "BlockMetadata", "Chain", "Concatenator", "Count",
    "Dataset", "DatasetPipeline", "GroupedDataset", "LabelEncoder", "Max",
    "Mean", "Min", "MinMaxScaler", "OneHotEncoder", "Preprocessor",
    "SimpleImputer", "StandardScaler", "Std", "Sum", "TaskPoolStrategy",
    "aggregate", "from_arrow", "from_items", "from_numpy",
    "from_pandas", "from_torch", "range", "range_tensor", "read_binary_files", "read_csv", "read_images", "read_tfrecords",
    "read_datasource", "read_json", "read_numpy", "read_parquet",
    "read_text",
]
