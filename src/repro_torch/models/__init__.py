from repro_torch.models.transformer import LM, SSMLM, build_model

__all__ = ["LM", "SSMLM", "build_model"]
