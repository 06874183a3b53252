"""The import probe: after a run's imports, set-up, window and check at a
tiny CPU size, no loaded module has the top-level name of JAX or of the
JAX package (whole names: the port's begins with the JAX package's)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.run import run_workload
from benchmark.tests.conftest import TINY_SEED, tiny_cell
result = run_workload({w!r}, TINY_SEED, 0.5, {trace}, "cpu", tiny_cell({w!r}))
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"result": result is not None, "modules": tops}}))
"""


@pytest.mark.parametrize("workload,trace", [("model_l.train", False),
                                            ("unet3d_patch.train", True),
                                            ("model_l.segment", False)])
def test_no_jax_after_a_run(workload, trace):
    code = PROBE.format(root=str(harness.ROOT), w=workload, trace=trace)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert probe["result"]
    assert "ctseg_tpu_torch" in probe["modules"]
    assert not set(probe["modules"]) & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("ctseg_tpu_torch", sys.modules[__name__])
    assert "ctseg_tpu_torch" not in harness.forbidden_modules()
