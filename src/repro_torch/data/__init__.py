from repro_torch.data.pipeline import DcnnBatches, VolumeBatches  # noqa: F401
