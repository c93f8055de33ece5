from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder)
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_analyzer import DataAnalyzer
