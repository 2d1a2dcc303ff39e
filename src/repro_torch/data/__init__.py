from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, packed_batches  # noqa: F401
