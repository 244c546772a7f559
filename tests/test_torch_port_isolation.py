"""PyTorch port: the package stands alone, and its entry points do not
fall back to the CPU.

``flexflow_tpu_torch`` must import neither jax nor anything of the JAX
package ``flexflow_tpu`` (the machine with the card has no JAX), and an
entry point asked for the card on a machine without one raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import flexflow_tpu_torch as P
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "flexflow_tpu_torch"


def _forbidden(module: str) -> bool:
    # mind the prefix: flexflow_tpu_torch itself starts with flexflow_tpu
    return (module == "jax" or module.startswith("jax.")
            or module == "ml_dtypes" or module.startswith("ml_dtypes.")
            or module == "flexflow_tpu" or module.startswith("flexflow_tpu."))


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import flexflow_tpu_torch, flexflow_tpu_torch.serve, "
        "flexflow_tpu_torch.weights, flexflow_tpu_torch.models, "
        "flexflow_tpu_torch.cuda_build, flexflow_tpu_torch.serve.loadgen, "
        "flexflow_tpu_torch.optimizers, flexflow_tpu_torch.losses, "
        "flexflow_tpu_torch.metrics, flexflow_tpu_torch.search.unity, "
        "flexflow_tpu_torch.ops.fused_update, flexflow_tpu_torch.machine, "
        "flexflow_tpu_torch.search.native, flexflow_tpu_torch.search.rewrite, "
        "flexflow_tpu_torch.parallel.strategy, "
        "flexflow_tpu_torch.parallel.pipeline_detect, "
        "flexflow_tpu_torch.layout, flexflow_tpu_torch.models.mlp, "
        "flexflow_tpu_torch.step_graph, flexflow_tpu_torch.serve.kv_cache, "
        "flexflow_tpu_torch.models.llama, flexflow_tpu_torch.ops.embedding, "
        "flexflow_tpu_torch.ops.conv, flexflow_tpu_torch.ops.tensor_ops, "
        "flexflow_tpu_torch.models.dlrm, flexflow_tpu_torch.models.xdl, "
        "flexflow_tpu_torch.models.candle_uno, "
        "flexflow_tpu_torch.models.resnext, "
        "flexflow_tpu_torch.models.inception, "
        "flexflow_tpu_torch.models.resnet, flexflow_tpu_torch.models.alexnet, "
        "flexflow_tpu_torch.transforms, flexflow_tpu_torch.ops.norm, "
        "flexflow_tpu_torch.ckpt, flexflow_tpu_torch.ckpt.tree, "
        "flexflow_tpu_torch.ckpt.manifest, flexflow_tpu_torch.ckpt.faults, "
        "flexflow_tpu_torch.ckpt.sharded, flexflow_tpu_torch.ckpt.manager, "
        "flexflow_tpu_torch.ckpt.elastic, flexflow_tpu_torch.checkpoint, "
        "flexflow_tpu_torch.runtime_health, flexflow_tpu_torch.recompile, "
        "flexflow_tpu_torch.serve.loader, flexflow_tpu_torch.version, "
        "flexflow_tpu_torch.utils.logger, flexflow_tpu_torch.obs, "
        "flexflow_tpu_torch.obs.artifacts, flexflow_tpu_torch.obs.tracer, "
        "flexflow_tpu_torch.obs.inspect, flexflow_tpu_torch.obs.devtrace, "
        "flexflow_tpu_torch.obs.drift, flexflow_tpu_torch.obs.roofline, "
        "flexflow_tpu_torch.obs.simtrace, flexflow_tpu_torch.search.profile, "
        "flexflow_tpu_torch.search.validate, flexflow_tpu_torch.costmodel, "
        "flexflow_tpu_torch.costmodel.corpus, "
        "flexflow_tpu_torch.costmodel.model, flexflow_tpu_torch.scripts, "
        "flexflow_tpu_torch.scripts.costmodel, "
        "flexflow_tpu_torch.scripts.calibrate, "
        "flexflow_tpu_torch.scripts.obs_report, "
        "flexflow_tpu_torch.scripts.roofline, "
        "flexflow_tpu_torch.scripts.ckpt_inspect, "
        "flexflow_tpu_torch.scripts.supervise\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "flexflow_tpu_torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in list(PORT.rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((REPO / path).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m)] == []


# the measurement and observability modules: no TPU figure may price or
# bound anything measured on the card (a v5e's HBM rate, its bf16 peak,
# its vector memory)
MEASURE_MODULES = ("search/profile.py", "search/validate.py",
                   "obs/artifacts.py", "obs/tracer.py", "obs/devtrace.py",
                   "obs/inspect.py", "obs/drift.py", "obs/roofline.py",
                   "obs/simtrace.py", "utils/logger.py", "version.py",
                   "costmodel/corpus.py", "costmodel/model.py",
                   "scripts/costmodel.py", "scripts/calibrate.py",
                   "scripts/roofline.py")


@pytest.mark.parametrize("module", MEASURE_MODULES)
def test_no_tpu_figure_in_the_measurement_modules(module):
    src = (PORT / module).read_text()
    for figure in ("0.82e12", "819e9", "197e12", "128 * 1024 * 1024",
                   "_VMEM_BYTES"):
        assert figure not in src, f"{module} holds {figure}"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.FFModel(P.FFConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.FFModel(P.FFConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_transformer(TransformerConfig(num_layers=1, hidden_size=64,
                                             num_heads=1, seq_length=8,
                                             batch_size=2))
    from flexflow_tpu_torch.serve.loadgen import build_serve_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serve_model("transformer", on_cpu=True)


def test_detect_machine_spec_does_not_fall_back_to_the_cpu(monkeypatch):
    """``detect_machine_spec(device=None)`` resolves the device as
    ``FFModel`` does: the card, or an error when there is none; the CPU
    only by name."""
    from flexflow_tpu_torch.machine import detect_machine_spec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_machine_spec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_machine_spec(1)
    assert detect_machine_spec(device="cpu").chip == "cpu-sim"


@pytest.mark.parametrize("build", ["dlrm", "xdl", "candle_uno", "resnext50",
                                   "inception_v3"])
def test_zoo_builders_raise_without_cuda(monkeypatch, build):
    import flexflow_tpu_torch.models as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = {"dlrm": M.DLRMConfig, "xdl": M.XDLConfig,
              "candle_uno": M.CandleUnoConfig, "resnext50": M.ResNeXtConfig,
              "inception_v3": M.InceptionConfig}[build]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(M, f"create_{build}")(config())


def test_cpu_only_when_asked():
    ff = P.FFModel(P.FFConfig(), device="cpu")
    assert ff.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        P.FFModel(P.FFConfig(), device="meta")


def test_cpu_compute_dtype_is_f32():
    ff = create_transformer(TransformerConfig(num_layers=1, hidden_size=64,
                                              num_heads=1, seq_length=8,
                                              batch_size=2), device="cpu")
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=P.CompMode.INFERENCE)
    assert ff.executor.compute_dtype == torch.float32
    assert "__compute_params__" not in ff.state
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for sub in ff.params.values() for t in sub.values())


@pytest.mark.parametrize("build", ["resnet", "alexnet"])
def test_conv_bn_builders_raise_without_cuda(monkeypatch, build):
    import flexflow_tpu_torch.models as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if build == "resnet":
            M.create_resnet(M.ResNetConfig(batch_norm=True))
        else:
            M.create_alexnet()
