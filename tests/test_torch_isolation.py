"""The port stands alone: no module of msla_tpu_torch/, and not chip_smoke.py,
imports JAX, flax, optax, msgpack, tensorboardX, tensorboard or wandb (the
card's machine has none) or the JAX package, and no kernel wrapper catches an exception (a failed launch must
raise, never fall back to the plain version). The port does all the JAX
package does: every module of msla_tpu/ has a file at the same path in
msla_tpu_torch/, or the one COUNTERPARTS names."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "msla_tpu", "tensorboardX",
             "tensorboard", "wandb"}
FILES = sorted((ROOT / "msla_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(name, line) for name, line in _imported_roots(tree) if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for expected in ("msla_tpu_torch/inference.py", "msla_tpu_torch/ops/conv_stem.py",
                     "msla_tpu_torch/ops/deconv_stem.py",
                     "msla_tpu_torch/ops/nearest_codes.py", "msla_tpu_torch/ops/vq_fused.py",
                     "msla_tpu_torch/ops/vq.py", "msla_tpu_torch/ops/conv_adjoints.py",
                     "msla_tpu_torch/ops/metrics.py", "msla_tpu_torch/ops/stft.py",
                     "msla_tpu_torch/data/augment.py", "msla_tpu_torch/data/datamodule.py",
                     "msla_tpu_torch/models/module.py", "msla_tpu_torch/models/vqvae.py",
                     "msla_tpu_torch/train/trainer.py", "msla_tpu_torch/train/checkpoint.py",
                     "msla_tpu_torch/train/callbacks.py", "msla_tpu_torch/train/loggers.py",
                     "msla_tpu_torch/ops/flash_attn.py",
                     "msla_tpu_torch/ops/mlm_argmax.py", "msla_tpu_torch/nn/attention.py",
                     "msla_tpu_torch/nn/bert.py", "msla_tpu_torch/models/bert.py",
                     "msla_tpu_torch/utils/jax_compat.py", "msla_tpu_torch/ops/vq_lean.py",
                     "msla_tpu_torch/ops/vq_precision.py",
                     "msla_tpu_torch/tools/bench_vq_lean.py",
                     "msla_tpu_torch/tools/bench_vq_precision.py",
                     "msla_tpu_torch/data/wavio.py", "msla_tpu_torch/data/resample.py",
                     "msla_tpu_torch/data/native.py", "msla_tpu_torch/data/dataset.py",
                     "msla_tpu_torch/data/loader.py", "msla_tpu_torch/config/node.py",
                     "msla_tpu_torch/config/compose.py", "msla_tpu_torch/config/instantiate.py",
                     "msla_tpu_torch/config/runtime.py", "msla_tpu_torch/utils/pylogger.py",
                     "msla_tpu_torch/utils/util.py", "msla_tpu_torch/utils/instantiators.py",
                     "msla_tpu_torch/utils/plotting.py", "msla_tpu_torch/models/demo.py",
                     "msla_tpu_torch/main.py", "msla_tpu_torch/__main__.py",
                     "msla_tpu_torch/nn/positional.py", "msla_tpu_torch/nn/moe.py",
                     "msla_tpu_torch/nn/transformer_net.py",
                     "msla_tpu_torch/models/transformer.py",
                     "msla_tpu_torch/utils/tfevents.py", "msla_tpu_torch/utils/msgpack.py",
                     "msla_tpu_torch/sweep/space.py", "msla_tpu_torch/sweep/sampler.py",
                     "msla_tpu_torch/sweep/sweeper.py", "msla_tpu_torch/parallel/mesh.py",
                     "msla_tpu_torch/parallel/distributed.py",
                     "msla_tpu_torch/parallel/launch.py", "msla_tpu_torch/nn/vgg.py",
                     "msla_tpu_torch/nn/perceptual_loss.py", "chip_smoke.py"):
        assert expected in names


#: modules of the JAX package whose counterpart in the port has another name
COUNTERPARTS = {"ops/vq_pallas.py": "ops/nearest_codes.py",
                "utils/torch_compat.py": "utils/jax_compat.py"}


@pytest.mark.parametrize("module", sorted(
    p.relative_to(ROOT / "msla_tpu").as_posix() for p in (ROOT / "msla_tpu").rglob("*.py")))
def test_every_jax_module_has_a_counterpart(module):
    assert (ROOT / "msla_tpu_torch" / COUNTERPARTS.get(module, module)).is_file()


@pytest.mark.parametrize("name", ["conv_stem", "deconv_stem", "nearest_codes", "vq_fused",
                                  "flash_attn", "mlm_argmax", "vq_lean", "vq_precision"])
def test_kernel_wrappers_have_no_fallback(name):
    tree = ast.parse((ROOT / "msla_tpu_torch" / "ops" / f"{name}.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
