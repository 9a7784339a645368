"""The PyTorch port stands alone: ray_tpu_torch and chip_smoke.py import
neither jax nor anything of the JAX package (ray_tpu), its entry points
run on CUDA unless asked for the CPU, and importing it builds nothing."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ray_tpu_torch")


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def port_modules():
    mods = []
    for path in port_sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel == "chip_smoke":
            continue
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def forbidden(name: str) -> bool:
    """jax*, or the JAX package itself: `ray_tpu` or `ray_tpu.<x>` (not
    `ray_tpu_torch`, which merely starts with the same letters)."""
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "ray_tpu"


def test_forbidden_matches_the_right_names():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("jaxlib")
    assert forbidden("ray_tpu") and forbidden("ray_tpu.models.generate")
    assert not forbidden("ray_tpu_torch") and not forbidden(
        "ray_tpu_torch.ops.flash_attention")


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_ray_tpu_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str) and forbidden(arg.value):
                    bad.append(arg.value)
    assert not bad, f"{path} imports {bad}"


def run_py(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    """Every port module imports without pulling jax or ray_tpu into
    sys.modules, without looking for nvcc or starting a process, and
    without touching CUDA."""
    mods = port_modules()
    proc = run_py(f"""
        import importlib, shutil, subprocess, sys
        def refuse(*a, **k):
            raise AssertionError("import looked for nvcc or ran a process")
        shutil.which = refuse
        subprocess.Popen = refuse
        subprocess.run = refuse
        import torch
        torch.cuda.init = refuse
        torch.cuda._lazy_init = refuse
        for m in {mods!r}:
            importlib.import_module(m)
        from ray_tpu_torch.ops import _build
        assert not _build._libs and not _build.build_log
        loaded = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
        print("LOADED", loaded)
        print("COUNT", len({mods!r}))
        """)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    assert f"COUNT {len(mods)}" in proc.stdout
    assert len(mods) >= 10


def test_engine_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = configs.tiny_test()
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(cfg, params)


def test_chip_smoke_refuses_to_run_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_wrapper_has_no_fallback_path():
    """No try/except in the kernel wrappers (forward and backward) or the
    build: a build or launch failure on a CUDA tensor propagates, it is
    never caught and answered with the plain version. The autograd
    backward goes to flash_attention_bwd, whose CUDA branch is the kernel
    wrapper alone, and no port module calls a library attention."""
    for rel in ("ops/flash_attention.py", "ops/_build.py"):
        with open(os.path.join(PKG, rel)) as f:
            tree = ast.parse(f.read())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{rel} has try blocks at lines {tries}"
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    def calls(fn):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        return {getattr(n.func, "attr", getattr(n.func, "id", None))
                for n in ast.walk(tree) if isinstance(n, ast.Call)}

    assert "flash_attention_bwd" in calls(fa._FlashAttention.backward)
    assert "flash_attention_bwd_plain" not in calls(
        fa._FlashAttention.backward)
    bwd = ast.parse(textwrap.dedent(inspect.getsource(
        fa.flash_attention_bwd)))
    cuda_branch = next(n for n in ast.walk(bwd) if isinstance(n, ast.If)
                       and "is_cuda" in ast.unparse(n.test))
    assert [ast.unparse(s) for s in cuda_branch.body] == [
        "return _bwd_cuda(q, k, v, do, out, lse, causal, sm_scale, "
        "q_offset, kv_offset)"]
    for path in port_sources():
        if path.endswith("chip_smoke.py"):  # times SDPA as a yardstick
            continue
        with open(path) as f:
            src = f.read()
        assert "scaled_dot_product_attention" not in src, path
