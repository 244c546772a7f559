"""Deferred layer graph.

PyTorch counterpart of ``flexflow_tpu/layer.py``: the frontend builds a
list of symbolic layers with string-keyed property bags; operators are
materialized from them at ``compile`` time.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.tensor import Tensor


class Layer:
    _next_guid = [1]

    def __init__(
        self,
        op_type: OperatorType,
        name: Optional[str],
        inputs: List[Tensor],
        numOutputs: int = 1,
        data_type: DataType = DataType.FLOAT,
    ):
        self.guid = Layer._next_guid[0]
        Layer._next_guid[0] += 1
        self.op_type = op_type
        self.name = name or f"{op_type.name.lower()}_{self.guid}"
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        self.data_type = data_type
        self.properties: Dict[str, Any] = {}

    def add_property(self, key: str, value: Any) -> None:
        self.properties[key] = value

    def get_property(self, key: str, default: Any = None) -> Any:
        return self.properties.get(key, default)

    def __repr__(self):
        return f"Layer<{self.guid}:{self.op_type.name}:{self.name}>"
