"""`python -m ctseg_tpu_torch <command> ...`: one front door to every CLI of
the port (port of ctseg_tpu/__main__.py).

The same command names as the JAX package's table, each pointing at the
port's module. Nothing is imported, not even torch, until a command is
chosen; the command's remaining arguments go verbatim to the target's own
parser, so `python -m ctseg_tpu_torch evaluate --help` is
`python -m ctseg_tpu_torch.inference.evaluate --help`.
"""

from __future__ import annotations

import importlib
import sys

# command -> (module whose main() runs, argv prefix injected before the
# user's args, one-line description for the catalog).
COMMANDS: dict[str, tuple[str, tuple[str, ...], str]] = {
    "download": (
        "ctseg_tpu_torch.data.download",
        (),
        "download + seed-42 split of the PDDCA dataset",
    ),
    "process": (
        "ctseg_tpu_torch.data.process_miccai",
        (),
        "convert NRRD patients to 2D/3D npz and packed arrays",
    ),
    "stats": (
        "ctseg_tpu_torch.data.stats",
        (),
        "re-derive the published dataset constants (crop box, norm stats, weights)",
    ),
    "train": (
        "ctseg_tpu_torch.training.cli",
        ("train",),
        "train the 2D slice UNet (Model L recipe)",
    ),
    "train_mixup": (
        "ctseg_tpu_torch.training.cli",
        ("train_mixup",),
        "train with weighted mixup (Model M recipe)",
    ),
    "train_3d": (
        "ctseg_tpu_torch.training.cli",
        ("train_3d",),
        "train the volumetric UNet (resize parity or patch mode)",
    ),
    "evaluate": (
        "ctseg_tpu_torch.inference.evaluate",
        (),
        "Dice(+HD95) over a split; 2D slice or 3D sliding-window from hparams",
    ),
    "predict": (
        "ctseg_tpu_torch.inference.predict",
        (),
        "scan NRRD -> segmentation label map + per-structure NRRDs",
    ),
    "serve": (
        "ctseg_tpu_torch.inference.serve",
        (),
        "warm HTTP segmentation server",
    ),
    "export": (
        "ctseg_tpu_torch.inference.export",
        (),
        "checkpoint -> self-contained torch.export inference artifact",
    ),
    "gradcam": (
        "ctseg_tpu_torch.interpret.run",
        (),
        "GradCAM maps for all 9 structures over the test split",
    ),
    "parity": (
        "ctseg_tpu_torch.parity_report",
        (),
        "per-organ Dice parity report vs the reference's published table",
    ),
}


def _usage() -> str:
    width = max(map(len, COMMANDS))
    lines = [f"  {name:<{width}}  {desc}" for name, (_, _, desc) in COMMANDS.items()]
    return ("usage: python -m ctseg_tpu_torch <command> [args...]\n\ncommands:\n"
            + "\n".join(lines) + "\n\n`python -m ctseg_tpu_torch <command> "
            "--help` shows that command's options.")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0 if argv else 2
    name, rest = argv[0], argv[1:]
    if name not in COMMANDS:
        print(f"unknown command: {name!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    module, prefix, _ = COMMANDS[name]
    # The target's main() is called directly (every target defines one), not
    # re-executed as __main__, so an imported module is never run twice. It
    # parses the argv installed here; the caller's sys.argv comes back after.
    saved_argv = sys.argv
    sys.argv = [f"python -m ctseg_tpu_torch {name}", *prefix, *rest]
    try:
        ret = importlib.import_module(module).main()
    finally:
        sys.argv = saved_argv
    return int(ret) if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
