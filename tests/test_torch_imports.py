"""The port stands alone: importing every module of
distributed_pytorch_tpu_torch pulls in neither JAX nor the JAX package."""

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
                "lm_cli", "ops.nn", "ops.losses", "data.lm_corpus"):
        assert f"distributed_pytorch_tpu_torch.{mod}" in got["modules"]
    assert got["bad"] == [], f"the port imported {got['bad']}"
