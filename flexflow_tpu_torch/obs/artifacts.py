"""Artifact conventions shared by every obs writer.

The port's counterpart of ``flexflow_tpu/obs/artifacts.py``, with the
same header fields, so that the JAX package's tools read either
package's artifacts. Each JSON artifact carries a ``header`` with the
framework version, the platform and device of the model that produced
it, the host id and a wall-clock timestamp. The platform is ``"gpu"``
and the device ``torch.cuda.get_device_name`` for a model on a CUDA card,
``"cpu"`` and the host's processor for a model the caller put on the
CPU, and ``"unknown"`` when the writer was given no device. The host id
is the ``torch.distributed`` rank when a process group is initialised,
else 0. Writes are atomic (write-temp-then-rename), so a crashed run
never leaves a half-written file for the next tool.
"""

from __future__ import annotations

import json
import os
import platform as _platform
import tempfile
import time
from typing import Any, Dict, Optional, Tuple


def device_identity(device=None) -> Tuple[str, str]:
    """(platform, device kind) of a torch device: ("gpu", the card's
    name), ("cpu", the host's processor), or ("unknown", "unknown")
    for None."""
    if device is None:
        return "unknown", "unknown"
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", (_platform.processor() or _platform.machine() or "cpu")


def host_index() -> int:
    """The ``torch.distributed`` rank when a process group is up, else 0."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def artifact_header(host_id: Optional[int] = None,
                    kind: Optional[str] = None,
                    device=None) -> Dict[str, Any]:
    """Provenance header every trace/census/drift artifact embeds;
    ``device`` is the model's torch device."""
    from flexflow_tpu_torch.version import __version__

    platform, dev = device_identity(device)
    header = dict(
        flexflow_tpu_version=__version__,
        created_unix=time.time(),
        platform=platform,
        device=dev,
        host_id=int(host_index() if host_id is None else host_id),
    )
    if kind:
        header["kind"] = kind
    return header


def atomic_write_text(path: str, text: str) -> None:
    """Write-temp-then-rename in the destination directory (same fs).

    The temp name is dot-prefixed and ``.tmp``-suffixed, so a temp left
    behind by a killed process never matches a consumer's artifact
    pattern (``*.trace.json`` etc.)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_",
                               suffix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_artifact(path: str, payload: Dict[str, Any],
                   host_id: Optional[int] = None,
                   kind: Optional[str] = None,
                   header_extra: Optional[Dict[str, Any]] = None,
                   device=None) -> str:
    """Stamp ``payload`` with the provenance header (plus any
    ``header_extra`` fields, e.g. the tracer's run_name) and write it
    atomically. Returns ``path``."""
    body = dict(payload)
    if "header" not in body:
        header = artifact_header(host_id=host_id, kind=kind, device=device)
        header.update(header_extra or {})
        body["header"] = header
    atomic_write_text(path, json.dumps(body, indent=1, default=_json_safe))
    return path


def _json_safe(o):
    """Best-effort JSON coercion for numpy and torch scalars and odd
    leaves."""
    try:
        import numpy as np
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:
        pass
    if hasattr(o, "item") and callable(o.item):
        try:
            return o.item()
        except Exception:
            pass
    return str(o)
