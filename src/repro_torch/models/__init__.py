from repro_torch.models.transformer import LM, build_model

__all__ = ["LM", "build_model"]
