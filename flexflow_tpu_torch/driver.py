"""CLI launcher: ``python -m flexflow_tpu_torch.driver [flags] script.py``.

PyTorch counterpart of ``flexflow_tpu/driver.py``: consume ``FFConfig``
flags, expose the parsed config to the script through
``flexflow_tpu_torch.driver.get_config()``, then run the script with the
remaining argv:

    python -m flexflow_tpu_torch.driver -b 64 --budget 30 my_model.py --my-flag

One process drives one card. Under torchrun (``torchrun
--nproc-per-node N -m flexflow_tpu_torch.driver ... script.py``) the
launcher first starts the process group from torchrun's environment
(``distributed.initialize_from_config``), so the script's
``compile`` lays its mesh over the N ranks. ``--nodes`` above 1 (a
multi-host launch) raises: multi-node runs are ROADMAP.md Queue 1 item
13, on the multi-rank executor of item 3.
"""

from __future__ import annotations

import runpy
import sys
from typing import Optional

from flexflow_tpu_torch.config import FFConfig

_config: Optional[FFConfig] = None


def get_config() -> FFConfig:
    """The FFConfig parsed by the launcher (fresh default outside it)."""
    global _config
    if _config is None:
        _config = FFConfig()
    return _config


def main(argv=None) -> int:
    global _config
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = FFConfig()
    rest = cfg.parse_args(argv)
    script = next((a for a in rest if a.endswith(".py")), None)
    if script is None:
        print("usage: python -m flexflow_tpu_torch.driver [flags] script.py "
              "[args]", file=sys.stderr)
        return 2
    rest.remove(script)
    if cfg.num_nodes > 1:
        raise NotImplementedError(
            f"--nodes {cfg.num_nodes}: a multi-host launch is ROADMAP.md "
            f"Queue 1 item 13, on the multi-rank executor of item 3; the "
            f"port's driver runs the ranks of one node")
    from flexflow_tpu_torch import distributed
    distributed.initialize_from_config(cfg)
    _config = cfg
    # under ``python -m`` this module runs as __main__, and the script's
    # ``from flexflow_tpu_torch.driver import get_config`` imports a second
    # copy of it: hand that copy the parsed config too
    import flexflow_tpu_torch.driver as importable
    importable._config = cfg
    sys.argv = [script] + rest
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
