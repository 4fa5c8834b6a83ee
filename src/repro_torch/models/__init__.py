from repro_torch.models.transformer import (LM, SSMLM, EncDecLM, HybridLM,
                                           build_model)

__all__ = ["LM", "SSMLM", "HybridLM", "EncDecLM", "build_model"]
