"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or anything of the reference package."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the Mamba-2, MoE, dense-family, Whisper, mesh, SP-family and
    # training slices' modules are among them
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in files[:-1]}
    assert {"compat.py", "configs/mamba2_1_3b.py", "models/ssm.py",
            "kernels/ssd_scan.py", "kernels/flash_decode.py",
            "models/moe.py", "configs/qwen2_moe_a2_7b.py",
            "configs/chatglm3_6b.py", "configs/nemotron_4_15b.py",
            "configs/phi4_mini_3_8b.py", "configs/llama3_70b.py",
            "configs/qwen2_vl_72b.py", "configs/mixtral_8x22b.py",
            "configs/whisper_medium.py", "launch/mesh.py",
            "core/ring_attention.py", "core/zigzag.py",
            "configs/jamba_1_5_large_398b.py", "training/data.py",
            "training/optimizer.py", "training/train_loop.py",
            "training/checkpoint.py", "launch/train.py",
            "serving/kv_offload.py", "serving/kv_fabric.py",
            "serving/telemetry.py", "launch/steps.py", "launch/roofline.py",
            "launch/dryrun.py"} <= names
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for line, name in _imports(p)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_mesh_modules_import_without_jax():
    """The mesh, training, memory-tier and dry-run slices' modules, and
    the page helpers, import in a process where jax cannot be imported
    at all."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.mesh, repro_torch.core.ring_attention,"
            " repro_torch.models.attention, repro_torch.serving.engine,"
            " repro_torch.core.zigzag, repro_torch.models.moe,"
            " repro_torch.models.ssm, repro_torch.training.data,"
            " repro_torch.training.optimizer,"
            " repro_torch.training.train_loop,"
            " repro_torch.training.checkpoint, repro_torch.launch.train,"
            " repro_torch.serving.kv_offload, repro_torch.serving.kv_fabric,"
            " repro_torch.serving.telemetry, repro_torch.launch.steps,"
            " repro_torch.launch.roofline, repro_torch.launch.dryrun; "
            "from repro_torch.kernels.flash_decode import gather_kv_pages,"
            " scatter_kv_token, scatter_kv_prefill")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
