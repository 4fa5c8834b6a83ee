from repro_torch.models.transformer import LM, SSMLM, HybridLM, build_model

__all__ = ["LM", "SSMLM", "HybridLM", "build_model"]
