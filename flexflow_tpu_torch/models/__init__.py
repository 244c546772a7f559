"""Model constructors: the BERT-proxy transformer, the MLP, the
Llama-family decoder LM, the other five models of the OSDI'22 protocol
(DLRM, XDL, CANDLE-Uno, ResNeXt-50, Inception-v3), and the reference's
AlexNet and ResNet-50 (with or without BatchNorm), and the
mixture-of-experts classifier and encoder."""

from flexflow_tpu_torch.models.alexnet import create_alexnet
from flexflow_tpu_torch.models.candle_uno import (CandleUnoConfig,
                                                  create_candle_uno)
from flexflow_tpu_torch.models.dlrm import DLRMConfig, create_dlrm
from flexflow_tpu_torch.models.inception import (InceptionConfig,
                                                 create_inception_v3)
from flexflow_tpu_torch.models.llama import (LlamaModelConfig, create_llama,
                                             import_hf_weights)
from flexflow_tpu_torch.models.mlp import create_mlp
from flexflow_tpu_torch.models.moe_model import (MoEConfig, create_moe,
                                                 create_moe_encoder)
from flexflow_tpu_torch.models.resnet import ResNetConfig, create_resnet
from flexflow_tpu_torch.models.resnext import ResNeXtConfig, create_resnext50
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.models.xdl import XDLConfig, create_xdl

__all__ = ["CandleUnoConfig", "DLRMConfig", "InceptionConfig",
           "LlamaModelConfig", "MoEConfig", "ResNetConfig", "ResNeXtConfig",
           "TransformerConfig", "XDLConfig", "create_alexnet",
           "create_candle_uno", "create_dlrm", "create_inception_v3",
           "create_llama", "create_mlp", "create_moe",
           "create_moe_encoder", "create_resnet", "create_resnext50",
           "create_transformer", "create_xdl", "import_hf_weights"]
