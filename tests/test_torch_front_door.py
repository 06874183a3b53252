"""The port's front door (`python -m ctseg_tpu_torch`), its released-model
helpers and its parity report, on the CPU.

  - The command table has the JAX package's command names, each pointing at
    a module of the port with a main(); usage, unknown commands, argv
    forwarding and restoring, return codes, every command's --help; no
    torch imported until a command is chosen.
  - `models/released.py` resolves a local directory or file and says what
    is missing; `--from_released` works in predict, serve, evaluate and
    gradcam with a reference-layout Lightning `.ckpt` (nothing downloads).
  - `parity_report`'s table and reference numbers are the root script's
    (AST); `parity --checkpoint` on a tiny split writes the report.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ctseg_tpu
import ctseg_tpu_torch
from ctseg_tpu.__main__ import COMMANDS as JAX_COMMANDS
from ctseg_tpu_torch import parity_report
from ctseg_tpu_torch.__main__ import COMMANDS, main
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.inference import evaluate, predict, serve
from ctseg_tpu_torch.interpret import run as interpret_run
from ctseg_tpu_torch.models.released import (
    RELEASED_FILES,
    resolve_checkpoint_arg,
    resolve_released,
)
from ctseg_tpu_torch.testing.synth import make_patient
from torch_unet_oracle import ReferenceModelOracle

PKG = Path(ctseg_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
FILTERS = [2, 4, 8, 16, 32]


# ------------------------------------------------------------ front door
def test_usage_on_no_args(capsys):
    assert main([]) == 2
    out = capsys.readouterr().out
    assert "python -m ctseg_tpu_torch" in out
    for name in COMMANDS:
        assert name in out


def test_help_exits_zero(capsys):
    assert main(["--help"]) == 0
    assert "commands:" in capsys.readouterr().out


def test_unknown_command(capsys):
    assert main(["definitely_not_a_command"]) == 2
    assert "unknown command" in capsys.readouterr().err


def test_the_command_names_are_the_jax_tables():
    assert list(COMMANDS) == list(JAX_COMMANDS)
    for name, (module, prefix, desc) in COMMANDS.items():
        jax_module, jax_prefix, _ = JAX_COMMANDS[name]
        assert module.startswith("ctseg_tpu_torch."), name
        assert prefix == jax_prefix and desc
        # the same module path below the package (parity: the root script)
        assert module.removeprefix("ctseg_tpu_torch.") == \
            jax_module.removeprefix("ctseg_tpu.")


@pytest.mark.parametrize("name", list(COMMANDS))
def test_every_command_takes_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        main([name, "--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_main_restores_sys_argv():
    before = list(sys.argv)
    with pytest.raises(SystemExit):
        main(["stats", "--help"])
    assert sys.argv == before


def test_return_code_propagates(monkeypatch):
    import types

    from ctseg_tpu_torch import __main__ as front

    mod = types.ModuleType("_ctseg_torch_fake_cmd")
    mod.main = lambda: 7
    monkeypatch.setitem(sys.modules, "_ctseg_torch_fake_cmd", mod)
    monkeypatch.setitem(front.COMMANDS, "fake",
                        ("_ctseg_torch_fake_cmd", (), "x"))
    assert main(["fake"]) == 7
    mod.main = lambda: None
    assert main(["fake"]) == 0


def test_usage_imports_no_torch():
    code = ("import sys\n"
            "from ctseg_tpu_torch.__main__ import main\n"
            "assert main([]) == 2 and main(['--help']) == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax')]\n"
            "assert not bad, bad\n"
            "print('lean-ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "lean-ok" in r.stdout
    r = subprocess.run([sys.executable, "-m", "ctseg_tpu_torch"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "gradcam" in r.stdout


# ------------------------------------------------------ released models
@pytest.fixture(scope="module")
def released_dir(tmp_path_factory):
    """model_large.ckpt in the released Lightning layout (state_dict with
    the `unet.`/`conv1x1.` prefixes and `.adn.A.` PReLU keys,
    hyper_parameters), tiny filters."""
    torch.manual_seed(0)
    oracle = ReferenceModelOracle(2, 3, 10, tuple(FILTERS), (2, 2, 2, 2),
                                  num_res_units=2)
    sd = {k.replace(".act.", ".adn.A."): v
          for k, v in oracle.state_dict().items()}
    d = tmp_path_factory.mktemp("released")
    torch.save({
        "state_dict": sd,
        "hyper_parameters": {
            "batch_size": 4, "transform_degree": 1, "filters": FILTERS,
            "use_res_units": True, "downsample": False, "lr": 1e-3,
            "loss_fx": ["Focal", "Dice"], "exclude_missing": False,
        },
    }, d / "model_large.ckpt")
    return d


def test_resolve_released_local_dir_and_file(released_dir, tmp_path):
    ckpt = released_dir / "model_large.ckpt"
    assert resolve_released(str(released_dir), "model_l", tmp_path) == ckpt
    assert resolve_released(str(ckpt), "model_l", tmp_path) == ckpt
    assert not list(tmp_path.iterdir())  # nothing fetched, nothing written
    with pytest.raises(FileNotFoundError, match="model_mixup.ckpt"):
        resolve_released(str(released_dir), "model_m", tmp_path)
    assert RELEASED_FILES == {"model_l": "model_large.ckpt",
                              "model_m": "model_mixup.ckpt"}


def test_resolve_checkpoint_arg(released_dir):
    args = SimpleNamespace(checkpoint=None, from_released="model_l",
                           released_source=str(released_dir))
    assert resolve_checkpoint_arg(args).endswith("model_large.ckpt")
    args = SimpleNamespace(checkpoint="mine.ckpt", from_released=None,
                           released_source="github")
    assert resolve_checkpoint_arg(args) == "mine.ckpt"
    with pytest.raises(SystemExit, match="--from_released"):
        resolve_checkpoint_arg(SimpleNamespace(
            checkpoint=None, from_released=None, released_source="github"))


def _released(released_dir):
    return ["--from_released", "model_l", "--released_source",
            str(released_dir), "--device", "cpu"]


@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    rng = np.random.default_rng(3)
    n, hw = 4, 24
    labels = np.zeros((n, hw, hw), np.uint8)
    labels[:, 6:14, 6:14] = rng.integers(1, 10, (n, 1, 1))
    indicators = np.zeros((n, 9), bool)
    indicators[:, :6] = True
    d = tmp_path_factory.mktemp("split")
    PackedDataset2D(rng.normal(40, 300, (n, hw, hw)).astype(np.float32),
                    labels, indicators).save(d / "test_packed.npz")
    return d


def test_predict_from_released(released_dir, tmp_path):
    patient = make_patient(tmp_path / "scans" / "0522c0001", shape=(3, 24, 24),
                           seed=1)
    predict.main(_released(released_dir) + [
        "--input", str(patient), "--out", str(tmp_path / "out"), "--no_crop",
        "--no_structures"])
    assert (tmp_path / "out" / "0522c0001" / "segmentation.nrrd").exists()


def test_serve_from_released(released_dir, monkeypatch):
    started = {}

    class _Server:
        def serve_forever(self):
            started["ok"] = True

    def fake_serve(service, host, port):
        started["service"] = service
        return _Server()

    monkeypatch.setattr(serve, "serve", fake_serve)
    serve.main(_released(released_dir))
    assert started["ok"]
    service = started["service"]
    assert service.checkpoint == str(released_dir / "model_large.ckpt")
    assert service.config.num_res_units == 2
    assert tuple(service.config.filters) == tuple(FILTERS)


def test_evaluate_from_released(released_dir, test_split, tmp_path):
    out = tmp_path / "report.json"
    evaluate.main(_released(released_dir) + [
        "--data_dir", str(test_split), "--out", str(out)])
    result = json.loads(out.read_text())
    assert result["num_slices"] == 4
    assert set(result["per_structure_dice"]) == set(
        parity_report.REFERENCE_DICE["model_l"])


def test_gradcam_from_released(released_dir, test_split, tmp_path):
    interpret_run.main(_released(released_dir) + [
        "--data_dir", str(test_split), "--out_dir", str(tmp_path / "cams"),
        "--max_samples", "3", "--batch_size", "2", "--layer", "feat_down2"])
    cams = sorted((tmp_path / "cams").glob("*_gradcam.npy"))
    assert len(cams) == 3
    maps = np.load(cams[0])
    assert maps.shape == (9, 256, 256) and np.isfinite(maps).all()
    assert maps.min() >= 0


# --------------------------------------------------------- parity report
def _top_level(path: Path, names) -> dict:
    """The AST of each named top-level assignment or function."""
    found = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            found[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) in names:
            found[node.targets[0].id] = ast.dump(node)
    assert sorted(found) == sorted(names)
    return found


def test_parity_tables_equal_the_root_script():
    names = ("REFERENCE_DICE", "REFERENCE_MEAN", "PARITY_TOLERANCE",
             "comparison_table")
    assert _top_level(PKG / "parity_report.py", names) == \
        _top_level(REPO / "parity_report.py", names)
    result = {"mean_dice": 0.7198,
              "per_structure_dice": {s: v / 100 for s, v in
                                     parity_report.REFERENCE_DICE[
                                         "model_l"].items()}}
    table, ok = parity_report.comparison_table("model_l", result)
    assert ok and table.count("PASS") == 10


def test_interpret_write_sample_equals_the_jax_package():
    jax_pkg = Path(ctseg_tpu.__file__).resolve().parent
    assert _top_level(PKG / "interpret/run.py", ("_write_sample",)) == \
        _top_level(jax_pkg / "interpret/run.py", ("_write_sample",))


def test_parity_with_a_checkpoint_writes_the_report(released_dir, test_split,
                                                    tmp_path):
    out = tmp_path / "parity"
    parity_report.main([
        "--checkpoint", str(released_dir / "model_large.ckpt"), "--models",
        "model_l", "--data_dir", str(test_split), "--out_dir", str(out),
        "--device", "cpu"])
    payload = json.loads((out / "parity_report.json").read_text())
    result = payload["models"]["model_l"]["result"]
    assert result["num_slices"] == 4
    assert payload["models"]["model_l"]["parity_pass"] is False
    md = (out / "parity_report.md").read_text()
    assert "### model_l" in md and "BrainStem" in md
    # the same through the front door, from the released name
    out2 = tmp_path / "parity2"
    main(["parity", "--from_released", "model_l", "--released_source",
          str(released_dir), "--data_dir", str(test_split), "--out_dir",
          str(out2), "--device", "cpu"])
    again = json.loads((out2 / "parity_report.json").read_text())
    assert again["models"]["model_l"]["result"]["per_structure_dice"] == \
        result["per_structure_dice"]
