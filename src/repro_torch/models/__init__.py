"""The dense GQA decoder (``KIND_ATTN`` layers) as PyTorch modules."""
