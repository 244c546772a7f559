"""Model constructors: the BERT-proxy transformer and the MLP."""

from flexflow_tpu_torch.models.mlp import create_mlp
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)

__all__ = ["TransformerConfig", "create_mlp", "create_transformer"]
