"""Neither the harness's module tree nor the plain reference loads JAX
or the JAX package, compared by whole top-level names; the reference
loads nothing of the program either."""
import json
import subprocess
import sys

import _tiny

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{imports}
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""


def loaded(imports: str) -> set:
    code = PROBE.format(root=str(_tiny.ROOT), src=str(_tiny.ROOT / "src"),
                        imports=imports)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_tree_loads_no_jax():
    names = loaded(
        "import importlib, runpy\n"
        "run = runpy.run_path({!r})\n"
        "from perfbench import bench, control, faults, topology\n"
        "from perfbench.kinds import solve, path, serve\n"
        "import repro_torch.api, repro_torch.serving\n"
        "for w in json.load(open({!r}))['per_layer']:\n"
        "    bench.metric_reader(w['name'])\n".format(
            str(_tiny.ROOT / "perfbench" / "run.py"),
            str(_tiny.ROOT / "BENCHMARK.json")))
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in names and "perfbench" in names


def test_reference_loads_nothing_of_the_program():
    names = loaded("import perfbench.ref.alg1\nimport perfbench.work\n"
                   "from perfbench.losses import squared, logistic")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
