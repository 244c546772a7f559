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
        "flexflow_tpu_torch.scripts.supervise, "
        "flexflow_tpu_torch.analysis, flexflow_tpu_torch.analysis.dataflow, "
        "flexflow_tpu_torch.analysis.diagnostics, "
        "flexflow_tpu_torch.analysis.orchestrator, "
        "flexflow_tpu_torch.analysis.passes, "
        "flexflow_tpu_torch.analysis.passes.hygiene, "
        "flexflow_tpu_torch.analysis.passes.sharding, "
        "flexflow_tpu_torch.analysis.passes.layout, "
        "flexflow_tpu_torch.analysis.passes.dtype, "
        "flexflow_tpu_torch.analysis.passes.collectives, "
        "flexflow_tpu_torch.analysis.passes.multihost, "
        "flexflow_tpu_torch.analysis.passes.calibration, "
        "flexflow_tpu_torch.analysis.passes.checkpoint, "
        "flexflow_tpu_torch.scripts.fflint, "
        "flexflow_tpu_torch.scripts.explain, "
        "flexflow_tpu_torch.ops.moe, flexflow_tpu_torch.ops.experts, "
        "flexflow_tpu_torch.models.moe_model, "
        "flexflow_tpu_torch.dataloader, flexflow_tpu_torch.utils.dot, "
        "flexflow_tpu_torch.utils.graph_algorithms\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "flexflow_tpu_torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


EXAMPLES = REPO / "examples_torch"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in list(PORT.rglob("*.py"))
    + list(EXAMPLES.glob("*.py")) + [REPO / "chip_smoke.py"]))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((REPO / path).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m)] == []


def test_example_scripts_load_neither_jax_nor_the_jax_package():
    """Each ``examples_torch/`` script, imported as its ``python
    examples_torch/<name>.py`` run does (its folder on the path)."""
    names = sorted(p.stem for p in EXAMPLES.glob("*.py"))
    assert len(names) == 12  # common and the eleven scripts
    code = ("import sys\n"
            f"sys.path.insert(0, {str(EXAMPLES)!r})\n"
            + "".join(f"import {n}\n" for n in names)
            + "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "flexflow_tpu_torch" in loaded and "transformer" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


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


def test_moe_and_fit_loader_raise_without_cuda(monkeypatch):
    """The MoE builders, and a loader staging onto the card (what
    ``fit_loader`` on a card's model reads), raise on a machine without
    a card rather than run on the CPU."""
    import numpy as np

    from flexflow_tpu_torch import dataloader
    from flexflow_tpu_torch.models import (MoEConfig, create_moe,
                                           create_moe_encoder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_moe(MoEConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_moe_encoder(MoEConfig(num_encoder_layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataloader.stage(np.zeros((4, 2), np.float32), torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataloader.stage(np.zeros((4, 2), np.float32), None)


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


def test_frontends_load_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import flexflow_tpu_torch.torch, flexflow_tpu_torch.torch.model, "
        "flexflow_tpu_torch.onnx, flexflow_tpu_torch.onnx.proto, "
        "flexflow_tpu_torch.onnx.model, flexflow_tpu_torch.keras, "
        "flexflow_tpu_torch.keras.layers, flexflow_tpu_torch.keras.models, "
        "flexflow_tpu_torch.keras.datasets, "
        "flexflow_tpu_torch.keras.callbacks, "
        "flexflow_tpu_torch.keras.optimizers, "
        "flexflow_tpu_torch.keras.backend, flexflow_tpu_torch.driver, "
        "flexflow_tpu_torch.ops.matmul, flexflow_tpu_torch.ops.reduce\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "flexflow_tpu_torch.torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_the_torch_subpackage_shadows_nothing():
    """Importing ``flexflow_tpu_torch.torch`` sets the package attribute
    ``torch`` to the subpackage; the port's modules still reach PyTorch
    itself, and the package's normal path (build, compile, fit,
    predict) runs after it."""
    code = (
        "import flexflow_tpu_torch.torch as sub\n"
        "import flexflow_tpu_torch as P\n"
        "import flexflow_tpu_torch.model as M\n"
        "import numpy as np\n"
        "assert P.torch is sub and sub.__name__ == 'flexflow_tpu_torch.torch'\n"
        "assert M.torch.__name__ == 'torch' and hasattr(M.torch, 'matmul')\n"
        "from flexflow_tpu_torch.models.transformer import (\n"
        "    TransformerConfig, create_transformer)\n"
        "from flexflow_tpu_torch.optimizers import AdamOptimizer\n"
        "cfg = TransformerConfig(num_layers=1, hidden_size=32, num_heads=2,\n"
        "                        seq_length=8, batch_size=2)\n"
        "ff = create_transformer(cfg, device='cpu')\n"
        "ff.compile(AdamOptimizer(alpha=1e-3),\n"
        "           P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])\n"
        "rs = np.random.RandomState(0)\n"
        "x = rs.randn(2, 8, 32).astype(np.float32)\n"
        "ff.fit(x, rs.randn(2, 8, 1).astype(np.float32), epochs=1,\n"
        "       verbose=False)\n"
        "assert np.isfinite(ff.predict(x)).all()\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_frontends_raise_without_cuda(monkeypatch):
    """A Keras ``Model.compile`` and an fx ``torch_to_ff`` + ``compile``,
    asked for the card on a machine without one, raise rather than run
    on the CPU."""
    import numpy as np
    import torch.nn as nn
    from flexflow_tpu_torch.keras import Sequential
    from flexflow_tpu_torch.keras.layers import Dense, Input
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    from flexflow_tpu_torch.torch import PyTorchModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Sequential([Input((16,)), Dense(4)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.compile(optimizer="sgd", loss="mse", batch_size=8)
    assert model.ff is None
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ff = P.FFModel(P.FFConfig(batch_size=8), device=device)
            out = PyTorchModel(nn.Linear(16, 4)).torch_to_ff(
                ff, [ff.create_tensor((8, 16))])
            ff.compile(SGDOptimizer(lr=0.1),
                       P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
            ff.predict(np.zeros((8, 16), np.float32))


def test_driver_refuses_a_multi_host_launch(tmp_path):
    from flexflow_tpu_torch import driver

    script = tmp_path / "s.py"
    script.write_text("raise SystemExit('must not run')\n")
    with pytest.raises(NotImplementedError, match="item 3"):
        driver.main(["--nodes", "2", str(script)])


def test_driver_runs_a_script_with_its_config(tmp_path):
    """``python -m flexflow_tpu_torch.driver`` hands the script its parsed
    flags through ``get_config()`` and the rest as argv. (The JAX
    package's ``python -m flexflow_tpu.driver`` gives the script a
    default config: the script imports a second copy of the module.)"""
    script = tmp_path / "s.py"
    out = tmp_path / "out.txt"
    script.write_text(
        "import sys\n"
        "from flexflow_tpu_torch.driver import get_config\n"
        "cfg = get_config()\n"
        f"open({str(out)!r}, 'w').write(f'{{cfg.batch_size}} "
        "{cfg.search_budget} {sys.argv[1:]}')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.driver", "-b", "32",
         "--budget", "5", str(script), "--my-flag", "7"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert out.read_text() == "32 5 ['--my-flag', '7']"
