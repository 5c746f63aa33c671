"""What the benchmark loads: never JAX or the JAX package (top-level
names compared whole, so ``repro_torch`` is not ``repro``), and the
reference nothing of the program."""
import subprocess
import sys

from portbench import harness

ROOT = str(harness.ROOT)


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PYTHONPATH": f"{ROOT}/src:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_whole_name_comparison():
    from portbench.run import loaded_forbidden
    forbidden = harness.FORBIDDEN
    assert loaded_forbidden(forbidden, ["repro_torch", "repro_torch.models",
                                        "jaxtyping", "flaxen"]) == []
    assert loaded_forbidden(forbidden, ["repro.core.tree", "jax._src",
                                        "numpy"]) == ["jax", "repro"]


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import time\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "c = tiny_cell('train-rwkv6-1.6b')\n"
        "harness.run(c.name, 3, 0.1, True, 'cpu', time.perf_counter(),"
        " cell=c)\n")
    assert "repro_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import portbench.reference.common, portbench.reference.rwkv6, "
        "portbench.reference.transformer")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
