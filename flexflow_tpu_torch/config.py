"""FFConfig: run configuration + CLI flag surface.

PyTorch counterpart of ``flexflow_tpu/config.py``: the same field names
and defaults, so a configuration carries over between the two packages.
``parse_args`` consumes the flags of the fields the port reads (the
training flags, the machine model, the auto-parallelization search and
strategy files, the conv layout and the Conv+BN fold, checkpointing,
resume and the runtime-health flags) and leaves every other flag to the
application, as the reference leaves flags it does not know. The
observability flags are the reference's: ``--search-measure-ops`` and
``--measured-cache`` (per-op times on the device priced by the search,
``search/profile.py``), ``--profiling`` (the per-op table at compile),
``--trace-dir`` and ``--profile-steps`` (``obs/``), the window checked
when it is parsed; ``--lint off|warn|error`` runs the fflint static
verifier at compile (``analysis/``);
``--export-strategy-computation-graph PATH`` (the original FlexFlow's
``--compgraph``) writes the compiled strategy's Graphviz file, with each
op's FLOPs under ``--include-costs-dot-graph``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from flexflow_tpu_torch.ffconst import CompMode
from flexflow_tpu_torch.layout import LAYOUT_MODES


@dataclasses.dataclass
class FFConfig:
    # training flags
    epochs: int = 1
    batch_size: int = 64
    batch_size_explicit: bool = False  # True once -b/--batch-size is parsed
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    iterations: int = 1
    seed: int = 42

    # machine shape: devices per host (0 = all visible), hosts
    workers_per_node: int = 0
    num_nodes: int = 1
    coordinator_address: Optional[str] = None
    node_rank: int = -1
    slices: int = 1
    memory_per_chip_mb: int = 16 * 1024
    machine_model_version: int = 0
    machine_model_file: Optional[str] = None

    # auto-parallelization search
    search_budget: int = 0
    search_alpha: float = 0.05
    only_data_parallel: bool = False
    enable_sample_parallel: bool = True
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_inplace_optimizations: bool = True
    search_overlap_backward_update: bool = False
    base_optimize_threshold: int = 10
    enable_substitution: bool = True
    enable_pipeline_parallel: bool = True
    pipeline_microbatches: int = 0
    pipeline_schedule: str = "auto"
    pipeline_shard_queue: bool = True
    substitution_json: Optional[str] = None
    memory_search: bool = False
    memory_threshold_mb: Optional[int] = None
    search_measure_ops: bool = False
    measured_cache_file: Optional[str] = None
    search_trace: bool = False
    export_strategy_file: Optional[str] = None
    import_strategy_file: Optional[str] = None
    export_strategy_computation_graph_file: Optional[str] = None
    include_costs_dot_graph: bool = False

    # execution
    computation_mode: CompMode = CompMode.TRAINING
    perform_fusion: bool = True
    profiling: bool = False
    # bf16 compute with f32 master params on the card; f32 on the CPU
    allow_mixed_precision: bool = True
    # the conv family's execution layout (layout.py): "auto" computes
    # channels-last on the card and NCHW on the CPU; "nhwc"/"nchw" force
    # it. NCHW stays the API layout either way
    conv_compute_layout: str = "auto"
    # eval, forward and predict fold each Conv+BN(+ReLU) pair into one
    # convolution (layout.fold_conv_bn)
    fold_conv_bn: bool = True
    weight_update_sharding: str = "auto"
    overlap_bucket_mb: str = "auto"
    kernel_search: str = "auto"
    remat_search: str = "auto"
    lint: str = "off"
    trace_dir: Optional[str] = None
    profile_steps: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    checkpoint_retain: int = 3
    checkpoint_async: bool = True
    resume: bool = False
    grace_window_s: float = 0.0
    watchdog_timeout_s: float = 0.0

    @property
    def num_devices(self) -> int:
        """Explicit device count, or 0 meaning auto (use all visible)."""
        return self.workers_per_node * self.num_nodes

    def parse_args(self, argv: Sequence[str]) -> List[str]:
        """Consume the flags the port reads from ``argv``; return the
        rest. Flag names and their checks are the reference's."""
        rest: List[str] = []
        args = list(argv)
        i = 0

        def take() -> str:
            nonlocal i
            i += 1
            if i >= len(args):
                raise ValueError(f"flag {args[i - 1]} expects a value")
            return args[i]

        while i < len(args):
            a = args[i]
            if a in ("-e", "--epochs"):
                self.epochs = int(take())
            elif a in ("-b", "--batch-size"):
                self.batch_size = int(take())
                self.batch_size_explicit = True
            elif a == "--learning-rate":
                self.learning_rate = float(take())
            elif a == "--weight-decay":
                self.weight_decay = float(take())
            elif a in ("-i", "--iterations"):
                self.iterations = int(take())
            elif a == "--seed":
                self.seed = int(take())
            elif a in ("-ll:gpu", "-ll:tpu", "--workers-per-node"):
                self.workers_per_node = int(take())
            elif a in ("-ll:fsize", "--memory-per-chip"):
                self.memory_per_chip_mb = int(take())
            elif a == "--nodes":
                # hosts of a multi-host launch; the driver refuses > 1
                self.num_nodes = int(take())
            elif a in ("--budget", "--search-budget"):
                self.search_budget = int(take())
            elif a in ("--alpha", "--search-alpha"):
                self.search_alpha = float(take())
            elif a == "--only-data-parallel":
                self.only_data_parallel = True
            elif a == "--enable-parameter-parallel":
                self.enable_parameter_parallel = True
            elif a == "--enable-attribute-parallel":
                # the reference's quirk: this flag sets both
                self.enable_parameter_parallel = True
                self.enable_attribute_parallel = True
            elif a == "--enable-sample-parallel":
                self.enable_sample_parallel = True
            elif a == "--disable-pipeline-parallel":
                self.enable_pipeline_parallel = False
            elif a == "--pipeline-microbatches":
                v = take().lower()
                self.pipeline_microbatches = 0 if v == "auto" else int(v)
            elif a == "--pipeline-schedule":
                self.pipeline_schedule = _choice(
                    a, take(), ("auto", "gpipe", "circular"))
            elif a == "--pipeline-replicated-queue":
                self.pipeline_shard_queue = False
            elif a == "--substitution-json":
                self.substitution_json = take()
            elif a == "--disable-substitution":
                self.enable_substitution = False
            elif a == "--search-trace":
                self.search_trace = True
            elif a == "--memory-search":
                self.memory_search = True
            elif a == "--memory-threshold":
                self.memory_threshold_mb = int(take())
            elif a in ("--export-strategy", "--export"):
                self.export_strategy_file = take()
            elif a in ("--import-strategy", "--import"):
                self.import_strategy_file = take()
            elif a in ("--export-strategy-computation-graph", "--compgraph"):
                self.export_strategy_computation_graph_file = take()
            elif a == "--include-costs-dot-graph":
                self.include_costs_dot_graph = True
            elif a == "--machine-model-version":
                self.machine_model_version = int(take())
            elif a == "--machine-model-file":
                self.machine_model_file = take()
            elif a == "--overlap":
                self.search_overlap_backward_update = True
            elif a == "--disable-fusion":
                self.perform_fusion = False
            elif a == "--overlap-bucket-mb":
                v = take().lower()
                if v not in ("auto", "off"):
                    try:
                        int(v)
                    except ValueError:
                        raise ValueError(
                            f"--overlap-bucket-mb expects auto|off|N (MB), "
                            f"got {v!r}") from None
                self.overlap_bucket_mb = v
            elif a == "--conv-layout":
                self.conv_compute_layout = _choice(a, take(), LAYOUT_MODES)
            elif a == "--disable-conv-bn-fold":
                self.fold_conv_bn = False
            elif a == "--kernel-search":
                self.kernel_search = _choice(a, take(), ("auto", "off"))
            elif a == "--remat-search":
                self.remat_search = _choice(a, take(), ("auto", "off"))
            elif a == "--weight-update-sharding":
                self.weight_update_sharding = _choice(
                    a, take(), ("auto", "on", "off"))
            elif a == "--checkpoint-dir":
                self.checkpoint_dir = take()
            elif a == "--checkpoint-every":
                self.checkpoint_every = int(take())
            elif a == "--checkpoint-retain":
                v = int(take())
                if v < 1:
                    raise ValueError(
                        f"--checkpoint-retain expects >= 1 (the last "
                        f"complete checkpoint is never deleted), got {v}")
                self.checkpoint_retain = v
            elif a == "--checkpoint-sync":
                # commit on the training thread (the async writer is the
                # default)
                self.checkpoint_async = False
            elif a == "--resume":
                self.resume = True
            elif a == "--grace-window":
                v = float(take())
                if v < 0:
                    raise ValueError(
                        f"--grace-window expects seconds >= 0 (0 = no "
                        f"preemption handler), got {v}")
                self.grace_window_s = v
            elif a == "--watchdog-timeout":
                v = float(take())
                if v < 0:
                    raise ValueError(
                        f"--watchdog-timeout expects seconds >= 0 (0 = "
                        f"no watchdog), got {v}")
                self.watchdog_timeout_s = v
            elif a == "--search-measure-ops":
                self.search_measure_ops = True
            elif a == "--measured-cache":
                self.measured_cache_file = take()
            elif a == "--profiling":
                self.profiling = True
            elif a == "--trace-dir":
                self.trace_dir = take()
            elif a == "--profile-steps":
                v = take()
                # a bad window fails here, not steps into the traced run
                from flexflow_tpu_torch.obs.devtrace import \
                    parse_profile_steps
                parse_profile_steps(v)
                self.profile_steps = v
            elif a == "--lint":
                # the fflint static verifier at compile (analysis/)
                self.lint = _choice(a, take(), ("off", "warn", "error"))
            else:
                rest.append(a)
            i += 1
        return rest


def _choice(flag: str, value: str, allowed) -> str:
    v = value.lower()
    if v not in allowed:
        raise ValueError(f"{flag} expects {'|'.join(allowed)}, got {v!r}")
    return v
