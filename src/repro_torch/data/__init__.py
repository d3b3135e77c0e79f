from repro_torch.data.pipeline import DataConfig, DataPipeline, for_model

__all__ = ["DataConfig", "DataPipeline", "for_model"]
