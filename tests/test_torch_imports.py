"""The port imports neither JAX nor any module of the JAX package, whose
name is a prefix of the port's: the check compares module names exactly."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = "tencent_recommendation_2025_tpu"
PORT = "tencent_recommendation_2025_tpu_torch"

_PROBE = f"""
import importlib, json, pkgutil, sys
import {PORT} as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, "{PORT}.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({{"imported": names, "modules": sorted(sys.modules)}}))
"""


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == JAX_PKG
            or name.startswith(JAX_PKG + "."))


def test_port_imports_no_jax():
    import json

    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    imported = set(res["imported"])
    for mod in ("cli.infer", "ops.fused_block", "ops.kernels", "bridge",
                "models.baseline", "train.checkpoint", "retrieval.ann",
                "data.pipeline", "cli.train", "train.trainer",
                "train.telemetry", "ops.losses", "ops.sparse_table",
                "ops.flash_attention", "ops.hstu_attention",
                "models.attention", "models.encoder", "models.hstu",
                "parallel.mesh", "parallel.ring_fused",
                "parallel.ring_attention", "models.rqvae",
                "train.rqvae_trainer", "retrieval.semantic_serve",
                "cli.semantic", "utils.sysinfo", "utils.debug",
                "train.supervisor", "data.native_pack"):
        assert f"{PORT}.{mod}" in imported, mod
    bad = [m for m in res["modules"] if _forbidden(m)]
    assert not bad, bad
    assert PORT in res["modules"]


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py, imported as a module, loads no JAX module."""
    import json

    probe = ("import json, sys; import chip_smoke; "
             "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "chip_smoke" in mods
    assert not [m for m in mods if _forbidden(m)]


def test_every_kernel_source_is_built():
    """Every csrc/*.cu is a kernel source that ops/kernels.py builds, and
    each source's module is among those the first probe imports."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    csrc = ROOT / PORT / "csrc"
    assert set(kernels.SOURCES.values()) == {p.name
                                             for p in csrc.glob("*.cu")}
    assert kernels.SOURCES["sparse_table"] == "sparse_table.cu"


def test_exact_name_check():
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".config")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden(PORT) and not _forbidden(PORT + ".config")
    assert not _forbidden("jaxtyping")
