from repro_torch.data.synthetic import DataConfig, SyntheticStream, make_batch, frontend_stub
__all__ = ["DataConfig", "SyntheticStream", "make_batch", "frontend_stub"]
