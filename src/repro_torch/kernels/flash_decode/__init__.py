"""Flash-decode: one query token per head against a KV cache."""
