"""The port stands alone: importing every module of
distributed_pytorch_tpu_torch pulls in neither JAX nor the JAX package, and
no source of the port, nor chip_smoke.py or the port's scripts, names
either in an import."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, json, pkgutil, sys
import distributed_pytorch_tpu_torch as port
names = [m.name for m in
         pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from distributed_pytorch_tpu_torch import cli, eval, generate, serve, train
from distributed_pytorch_tpu_torch.models import vgg
from distributed_pytorch_tpu_torch.ops import attention, fused_bn, losses
from distributed_pytorch_tpu_torch.ops import quantized
for fn in (attention.decode_attention_paged,
           attention.decode_attention_paged_plain, generate.init_paged_cache,
           generate.verify_step_ragged, serve.prefix_page_hashes,
           train.Trainer, eval.evaluate, cli.main, vgg.init,
           fused_bn.bn_relu_bwd, fused_bn.bn_relu_bwd_plain,
           quantized.int8_matmul, quantized.int8_matmul_plain,
           quantized.quantized_matmul, losses.masked_ce_chunked):
    assert callable(fn)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib") or m.startswith(("jax.", "jaxlib."))
             or m == "distributed_pytorch_tpu"
             or m.startswith("distributed_pytorch_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("generate", "serve", "convert", "models.transformer",
                "ops.attention", "ops._build", "utils.tracing", "lm",
                "lm_cli", "ops.nn", "ops.losses", "data.lm_corpus",
                "models.vgg", "ops.fused_bn", "train", "eval", "cli",
                "data.cifar10", "data.sampler", "data.pipeline",
                "data.augment", "utils.metrics", "ops.quantized",
                "ops.moe", "utils.telemetry", "utils.monitor",
                "utils.logging", "utils.faults", "utils.checkpoint",
                "utils.sentry", "parallel.elastic", "launch"):
        assert f"distributed_pytorch_tpu_torch.{mod}" in got["modules"]
    assert got["bad"] == [], f"the port imported {got['bad']}"


def _banned(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "distributed_pytorch_tpu")


def test_port_sources_and_chip_smoke_import_no_jax():
    """Every import statement of the port's sources and of chip_smoke.py,
    at any depth (kernels import lazily inside functions), names neither
    JAX nor the JAX package."""
    files = sorted((ROOT / "distributed_pytorch_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "scripts").glob("torch_*.py")) + [
        ROOT / "scripts" / "observability_probe.py",
        ROOT / "scripts" / "phase_probe.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _banned(n)]
    assert len(files) > 10 and bad == [], bad
