"""Model constructors: the BERT-proxy transformer, the MLP and the
Llama-family decoder LM."""

from flexflow_tpu_torch.models.llama import (LlamaModelConfig, create_llama,
                                             import_hf_weights)
from flexflow_tpu_torch.models.mlp import create_mlp
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)

__all__ = ["LlamaModelConfig", "TransformerConfig", "create_llama",
           "create_mlp", "create_transformer", "import_hf_weights"]
