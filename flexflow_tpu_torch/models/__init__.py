"""Model constructors. This slice carries the BERT-proxy transformer."""

from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)

__all__ = ["TransformerConfig", "create_transformer"]
