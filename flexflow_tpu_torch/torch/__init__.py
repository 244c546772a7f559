"""PyTorch frontend: torch.fx tracing -> the port's FFModel.

PyTorch counterpart of ``flexflow_tpu/torch``. This subpackage is
``flexflow_tpu_torch.torch``: importing it sets that attribute on the
package, so the port's modules import PyTorch absolutely and the package
itself binds no global named ``torch``.
"""

from flexflow_tpu_torch.torch.model import (PyTorchModel, from_hf_causal_lm,
                                            torch_to_ff_file)

__all__ = ["PyTorchModel", "from_hf_causal_lm", "torch_to_ff_file"]
