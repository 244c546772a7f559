"""The machine model and named device meshes.

PyTorch counterpart of ``flexflow_tpu/machine.py``'s ``MachineSpec``,
``CHIP_SPECS``, ``_factor_torus``, ``detect_machine_spec`` and
``make_mesh``. A ``MachineSpec`` is what the search prices strategies on
(``search/unity.py`` ``machine_to_json``): one ICI domain (here an
NVSwitch node) of ``chips_per_slice`` devices, ``num_slices`` of them
joined by a DCN (here InfiniBand). The field names are the reference's,
because the native search core reads them.

A ``Mesh`` names its axes and their sizes, as the reference's
``jax.sharding.Mesh`` does; it holds no devices. One process runs a mesh
whose only axis above 1 is the sequence axis of ring attention: every
ring position lives on the model's one device
(``parallel/ring_attention.py``, ``LocalRing``). A mesh with any other
axis above 1 needs multi-GPU execution (ROADMAP.md Queue 1 items 3 and
10).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

# Per-chip figures: bf16 dense peak FLOP/s, HBM bytes/s, HBM bytes, ICI
# bytes/s per link direction, links per chip; a chip may also set the
# MachineSpec fields that default to None below.
CHIP_SPECS: Dict[str, Dict[str, float]] = {
    # the JAX package's CPU simulation figures, unchanged, so that both
    # packages price the same machine
    "cpu-sim": dict(flops=1e12, hbm_bw=100e9, hbm_cap=16e9, ici_bw=10e9,
                    ici_links=4),
    # NVIDIA H100 SXM5 80GB in an 8-GPU NVSwitch node (HGX/DGX H100).
    # Datasheet figures and two readings. A compile under
    # --search-measure-ops prices each op on times taken on the card
    # (search/profile.py) instead, a learned table (costmodel/) the
    # classes it covers, and the calibration file's gpu buckets scale
    # the measured ops and the collectives (search/profile.py
    # calibration_path).
    "h100-sxm": dict(
        flops=989e12,      # bf16 dense Tensor Core peak (H100 SXM datasheet)
        hbm_bw=3.35e12,    # HBM3 bandwidth (H100 SXM datasheet)
        hbm_cap=80e9,      # HBM3 capacity (H100 SXM datasheet)
        # NVLink 4: 18 links x 25 GB/s each way = 450 GB/s each way a GPU
        # (H100 SXM datasheet: 900 GB/s bidirectional). The native core
        # prices a ring at 2 x ici_bw (both directions of one link); over
        # NVSwitch a GPU's whole egress is 450 GB/s, so ici_bw is half.
        ici_bw=225e9,
        ici_links=18,
        ici_latency=1e-6,  # not a datasheet figure: the reference's default
        # InfiniBand NDR: 400 Gb/s = 50 GB/s, one ConnectX-7 port per GPU
        # (DGX H100 datasheet); latency the reference's default
        dcn_bw=50e9,
        dcn_latency=10e-6,
        # measured, not datasheet figures: the medians of ten runs of
        # chip_smoke.py's [search train] readings (NVIDIA H100 80GB HBM3
        # at 700.00 W; PERF.md). mxu_efficiency: the full-width
        # BERT-proxy FFN GEMM's achieved share of the bf16 peak (0.659 to
        # 0.693). min_op_time: one launch of a one-element elementwise
        # kernel back to back (6.8 to 13.0 us). It is host-paced: the
        # time the host takes to issue one launch, not a floor of the
        # device's, and not the host cost of a graph op either, which is
        # some 35 launches in the eager step (chip_smoke.py prints the
        # step's p50 over its graph ops beside it); the cost model charges
        # it once a graph op.
        mxu_efficiency=0.6787,
        min_op_time=11.69e-6,
    ),
}


def _factor_torus(n: int, dims: int) -> Tuple[int, ...]:
    """Near-equal ``dims``-way factorization of a slice's chip count into
    torus extents, largest first; fewer dims when n doesn't split."""
    if n <= 1:
        return (n,)
    out = []
    rem = n
    for i in range(dims, 1, -1):
        target = max(1, round(rem ** (1.0 / i)))
        f = max(d for d in range(1, target + 1) if rem % d == 0)
        if f > 1:
            out.append(f)
            rem //= f
    out.append(rem)
    return tuple(sorted((x for x in out if x > 1), reverse=True)) or (n,)


# the reference's defaults of the fields a chip entry may override
_FIELD_DEFAULTS = dict(dcn_bw=25e9, ici_latency=1e-6, dcn_latency=10e-6,
                       mxu_efficiency=0.55, min_op_time=5e-7)


@dataclasses.dataclass
class MachineSpec:
    """One ICI domain (a TPU slice, or an NVSwitch node) of
    ``chips_per_slice`` devices, ``num_slices`` of them on a DCN.

    ``torus`` holds the per-slice ICI extents; a 1-tuple means flat, which
    is how an NVSwitch node is modelled (every GPU one hop from every
    other), the reference's own mapping of a GPU node. Fields left None
    take the chip's figure, else the reference's default."""

    chip: str = "cpu-sim"
    chips_per_slice: int = 1
    num_slices: int = 1
    torus: Optional[Tuple[int, ...]] = None
    dcn_bw: Optional[float] = None  # bytes/s per slice pair
    ici_latency: Optional[float] = None
    dcn_latency: Optional[float] = None
    mxu_efficiency: Optional[float] = None  # achieved share of peak
    conv_efficiency: float = 0.35
    min_op_time: Optional[float] = None  # per-kernel floor (seconds)
    collective_launch_overhead: float = 2e-6
    # explicit slice-pair links [(i, j, bytes_per_s), ...]; None = uniform
    dcn_links: Optional[Sequence[Tuple[int, int, float]]] = None
    # measured per-collective-kind factors (kind -> measured/predicted)
    # of the calibration file's platform bucket (load_collective_
    # corrections); None or {} = uncalibrated
    collective_corrections: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.chip not in CHIP_SPECS:
            raise ValueError(f"unknown chip {self.chip!r}; known: "
                             f"{sorted(CHIP_SPECS)}")
        spec = CHIP_SPECS[self.chip]
        if self.torus is None:
            # the CPU simulation keeps the reference's 2-D default; a
            # switched GPU node is flat
            self.torus = (_factor_torus(self.chips_per_slice, 2)
                          if self.chip == "cpu-sim"
                          else (self.chips_per_slice,))
        for name, default in _FIELD_DEFAULTS.items():
            if getattr(self, name) is None:
                setattr(self, name, spec.get(name, default))
        self.flops = spec["flops"]
        self.hbm_bw = spec["hbm_bw"]
        self.hbm_cap = spec["hbm_cap"]
        self.ici_bw = spec["ici_bw"]

    # keys a --machine-model-file may set, with unit conversions from the
    # reference's GB/s + ms conventions where they map
    _FILE_KEYS = {
        "chip": ("chip", str),
        "chips_per_slice": ("chips_per_slice", int),
        "num_slices": ("num_slices", int),
        "flops": ("flops", float),
        "hbm_bw": ("hbm_bw", float),
        "hbm_cap": ("hbm_cap", float),
        "ici_bw": ("ici_bw", float),
        "ici_latency": ("ici_latency", float),
        "dcn_bw": ("dcn_bw", float),
        "dcn_latency": ("dcn_latency", float),
        "mxu_efficiency": ("mxu_efficiency", float),
        "conv_efficiency": ("conv_efficiency", float),
        "min_op_time": ("min_op_time", float),
        "collective_launch_overhead": ("collective_launch_overhead", float),
        "torus": ("torus",
                  lambda v: tuple(int(x) for x in
                                  (v.split() if isinstance(v, str) else v))),
        # the original FlexFlow's machine_config_example vocabulary (GB/s,
        # ms): nodes = DCN domains; nvlink -> ICI; nic -> DCN
        "num_nodes": ("num_slices", int),
        "nvlink_bandwidth": ("ici_bw", lambda v: float(v) * 1e9),
        "nvlink_latency": ("ici_latency", lambda v: float(v) * 1e-3),
        "nic_bandwidth": ("dcn_bw", lambda v: float(v) * 1e9),
        "nic_latency": ("dcn_latency", lambda v: float(v) * 1e-3),
        "dcn_links": ("dcn_links",
                      lambda v: [(int(i), int(j), float(bw))
                                 for i, j, bw in v]),
    }

    @classmethod
    def from_file(cls, path: str) -> "MachineSpec":
        """Parse a ``--machine-model-file``: JSON with this class's field
        names, or the ``key = value`` format (``dcn_link = i j bw``
        repeatable). Unknown keys are ignored."""
        with open(path) as f:
            text = f.read()
        values: Dict[str, object] = {}
        try:
            data = json.loads(text)
            if isinstance(data, dict):
                values = data
        except ValueError:
            for line in text.splitlines():
                line = line.split("#", 1)[0].strip()
                if "=" not in line:
                    continue
                k, v = (s.strip() for s in line.split("=", 1))
                if k == "dcn_link":
                    i, j, bw = v.split()
                    values.setdefault("dcn_links", []).append(
                        [int(i), int(j), float(bw)])
                else:
                    values[k] = v
        init = {}
        overrides = {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        for key, raw in values.items():
            mapped = cls._FILE_KEYS.get(key)
            if mapped is None:
                continue
            name, conv = mapped
            val = conv(raw)
            if name in field_names:
                init[name] = val
            else:
                overrides[name] = val  # flops/hbm_bw/...: post-init attrs
        spec = cls(**init)
        for name, val in overrides.items():
            setattr(spec, name, val)
        return spec

    @property
    def num_devices(self) -> int:
        return self.chips_per_slice * self.num_slices

    def effective_dcn(self) -> Tuple[float, float]:
        """(bandwidth, latency) of the cross-slice ring under the explicit
        fabric, or the uniform figures when none is given: each
        consecutive ring pair routes its hop-shortest, then
        widest-bottleneck path; the ring runs at its slowest pair, and
        latency scales with the longest routed path. Unreachable pairs
        take the uniform dcn_bw with a 2-hop penalty."""
        if not self.dcn_links or self.num_slices <= 1:
            return self.dcn_bw, self.dcn_latency
        S = self.num_slices
        adj: Dict[int, Dict[int, float]] = {i: {} for i in range(S)}
        for i, j, bw in self.dcn_links:
            i, j, bw = int(i), int(j), float(bw)
            if i == j or i >= S or j >= S:
                continue
            adj[i][j] = max(adj[i].get(j, 0.0), bw)
            adj[j][i] = max(adj[j].get(i, 0.0), bw)

        def route(a: int, b: int) -> Tuple[int, float]:
            best = {a: (0, float("inf"))}
            for _ in range(S):
                changed = False
                for u, (h, bw) in list(best.items()):
                    for v, link_bw in adj[u].items():
                        cand = (h + 1, min(bw, link_bw))
                        cur = best.get(v)
                        if cur is None or cand[0] < cur[0] or (
                                cand[0] == cur[0] and cand[1] > cur[1]):
                            best[v] = cand
                            changed = True
                if not changed:
                    break
            return best.get(b, (2, self.dcn_bw))

        worst_bw = float("inf")
        worst_hops = 1
        for i in range(S):
            hops, bw = route(i, (i + 1) % S)
            worst_bw = min(worst_bw, bw)
            worst_hops = max(worst_hops, hops)
        if not math.isfinite(worst_bw):
            worst_bw = self.dcn_bw
        return worst_bw, self.dcn_latency * worst_hops


def resolve_device(device=None):
    """``None`` means the card: CUDA device 0, or an error when there is
    no CUDA device. The CPU runs only when asked for by name."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "PyTorch port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def check_spec_device(machine_spec, device) -> None:
    """Raise unless ``machine_spec`` describes ``device``: the CPU pairs
    with ``"cpu-sim"`` only, a card with a card's entry only, so that no
    time taken on one is read against the other's peaks."""
    import torch

    on_cpu = torch.device(device).type == "cpu"
    if on_cpu != (machine_spec.chip == "cpu-sim"):
        raise ValueError(
            f"machine spec {machine_spec.chip!r} does not describe the "
            f"device {str(device)!r}: times taken there would be read "
            f"against another machine's peaks")


def load_collective_corrections(platform: str,
                                path: Optional[str] = None
                                ) -> Dict[str, float]:
    """Measured per-collective-kind factors (kind -> measured/predicted
    ratio) of the calibration file's ``collective_corrections`` bucket
    for one platform ("gpu", "cpu", ...). The file is the port's
    (``search/profile.py`` ``calibration_path``: ``path``, else
    ``FFS_CALIBRATION_FILE``, else the repo root's
    ``CALIBRATION_GPU.json``). {} when the file or bucket is absent:
    uncalibrated."""
    from flexflow_tpu_torch.search.profile import read_calibration

    bucket = (read_calibration(path).get("collective_corrections")
              or {}).get(platform) or {}
    out: Dict[str, float] = {}
    for kind, e in bucket.items():
        try:
            out[kind] = float(e["factor"] if isinstance(e, dict) else e)
        except (KeyError, TypeError, ValueError):
            continue
    return out


class UnknownDeviceError(RuntimeError):
    """The card has no entry in the machine table."""


def _cuda_chip(name: str, total_memory: int) -> str:
    """The ``CHIP_SPECS`` entry of a CUDA card: an H100 whose name says
    HBM3 (the SXM part, "NVIDIA H100 80GB HBM3") is ``h100-sxm``."""
    if "H100" in name and "HBM3" in name:
        return "h100-sxm"
    raise UnknownDeviceError(
        f"no machine model for the card {name!r} "
        f"({total_memory / 2 ** 30:.1f} GiB): the table holds "
        f"{sorted(c for c in CHIP_SPECS if c != 'cpu-sim')}; pass "
        f"--machine-model-file (or compile(machine_spec=...))")


def detect_machine_spec(num_devices: Optional[int] = None, slices: int = 1,
                        device=None) -> MachineSpec:
    """The MachineSpec of the devices the model runs on: ``"cpu-sim"``
    for the CPU, else the CUDA card's table entry (read from
    ``torch.cuda.get_device_name`` and ``get_device_properties``; a card
    without one raises ``UnknownDeviceError``). ``device`` is resolved as
    ``FFModel``'s is: ``None`` means the card, and raises when no CUDA
    device is present; the CPU only when asked for by name.
    ``num_devices`` defaults to the visible cards (1 on the CPU);
    ``slices > 1`` splits them into that many DCN-joined nodes. On a card
    the calibration file's ``gpu`` collective corrections engage
    (``load_collective_corrections``); never on the CPU, and not under
    ``FFS_NO_DRIFT_CORRECTIONS``."""
    import os

    import torch

    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to price the "
            "CPU")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        chip = _cuda_chip(torch.cuda.get_device_name(dev), props.total_memory)
        avail = torch.cuda.device_count()
    else:
        chip, avail = "cpu-sim", 1
    n = num_devices or avail
    s = max(1, int(slices))
    if s > 1 and n % s != 0:
        raise ValueError(
            f"--slices {s} does not divide the {n} devices")
    spec = MachineSpec(chip=chip, chips_per_slice=n // s, num_slices=s)
    if dev.type == "cuda" and not os.environ.get("FFS_NO_DRIFT_CORRECTIONS"):
        corr = load_collective_corrections("gpu")
        if corr:
            spec.collective_corrections = corr
    return spec


class Mesh:
    """Axis names and sizes of a logical device mesh."""

    def __init__(self, axes: Dict[str, int]):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axes {axes}: every size must be >= 1")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(num_devices: int, axes: Dict[str, int]) -> Mesh:
    """A named mesh of ``num_devices`` over ``axes`` (axis name -> size),
    whose sizes must multiply to ``num_devices``. Canonical names as in the
    reference: 'data', 'model', 'seq', 'expert', 'pipe'."""
    if math.prod(axes.values()) != num_devices:
        raise ValueError(f"mesh axes {axes} != {num_devices} devices")
    return Mesh(axes)


def local_ring_axis(mesh: Optional[Mesh],
                    seq_axes: Iterable[str] = ("seq",)) -> Optional[str]:
    """The axis of ``mesh`` that one process runs as a ring on one device:
    the one axis above 1, which must be one of ``seq_axes``; None when no
    axis is above 1. Raises NotImplementedError for any other mesh."""
    big = [a for a, n in (mesh.shape if mesh else {}).items() if n > 1]
    if not big:
        return None
    if len(big) > 1 or big[0] not in set(seq_axes):
        raise NotImplementedError(
            f"mesh {mesh.shape}: one process runs only a mesh whose one axis "
            f"above 1 is a ring-attention sequence axis {sorted(seq_axes)}; "
            f"other axes need multi-GPU execution, the multi-GPU slice of "
            f"the PyTorch port (ROADMAP.md Queue 1 item 3; a 'pipe' axis "
            f"item 10)")
    return big[0]
