"""Released reference checkpoints: resolution + CLI plumbing (a copy of
ctseg_tpu/models/released.py, the package prefix swapped; pinned equal by
tests/test_torch_port_imports.py).

The reference ships two trained Lightning checkpoints (Model L =
model_large.ckpt, Model M = model_mixup.ckpt; capstone/paths.py:46-49). The
port's `load_checkpoint` and `Trainer.restore` read a `.ckpt` file as it
is, and predict, serve, evaluate, the GradCAM CLI and the parity report
take `--from_released model_l|model_m [--released_source DIR|URL|github]`
to resolve the file by name.
"""

from argparse import ArgumentParser
from pathlib import Path

# Released-checkpoint filenames per parity model (reference paths.py:46-49).
RELEASED_FILES = {"model_l": "model_large.ckpt", "model_m": "model_mixup.ckpt"}


def resolve_released(source: str, name: str, out_dir: Path) -> Path:
    """Resolve a released-checkpoint source to a local .ckpt for `name`.

    `source` may be a local directory holding the released files, a local
    .ckpt file, or a URL prefix/full URL (fetched with urllib — blocked in
    zero-egress environments, in which case the error says exactly what to
    download). Defaults to the reference's GitHub release URLs
    (ctseg_tpu_torch.paths.TRAINED_MODELS) when source == "github".
    """
    from ctseg_tpu_torch.paths import TRAINED_MODELS

    fname = RELEASED_FILES[name]
    if source == "github":
        url = TRAINED_MODELS["large" if name == "model_l" else "mixup"]
    elif source.startswith(("http://", "https://")):
        url = source if source.endswith(".ckpt") else f"{source.rstrip('/')}/{fname}"
    else:
        p = Path(source)
        local = p if p.is_file() else p / fname
        if not local.exists():
            raise FileNotFoundError(
                f"--from_released: {local} not found (expected the released "
                f"checkpoint {fname}; see ctseg_tpu_torch.paths.TRAINED_MODELS)"
            )
        return local
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dest = out_dir / fname
    if dest.exists():
        return dest
    import os
    import urllib.request

    # Download to a .tmp name and rename on success (the checkpoint.py
    # pattern): an interrupted urlretrieve must not leave a truncated
    # .ckpt behind that a rerun's dest.exists() would silently reuse.
    tmp = out_dir / (fname + ".tmp")
    try:
        urllib.request.urlretrieve(url, tmp)  # noqa: S310 — pinned URLs
        os.replace(tmp, dest)
    except Exception as e:  # zero-egress container: say what to fetch
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"could not download {url} ({e}); fetch it on a connected "
            f"machine and pass --released_source <dir containing {fname}> "
            f"(the same flag on predict/serve/interpret/evaluate/parity)"
        ) from e
    return dest


def add_released_args(parser: ArgumentParser) -> None:
    """Add the shared --from_released/--released_source options."""
    parser.add_argument(
        "--from_released",
        choices=sorted(RELEASED_FILES),
        default=None,
        help="Load one of the reference's released checkpoints instead of "
        "--checkpoint (resolved via --released_source).",
    )
    parser.add_argument(
        "--released_source",
        type=str,
        default="github",
        help="Where the released .ckpt files live: a local directory, a "
        "URL prefix, or 'github' (the reference's release URLs).",
    )


def resolve_checkpoint_arg(args) -> str:
    """--checkpoint / --from_released -> a path Trainer.restore accepts."""
    if getattr(args, "from_released", None):
        from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE

        return str(
            resolve_released(
                args.released_source,
                args.from_released,
                Path(DEFAULT_DATA_STORAGE) / "released",
            )
        )
    if not args.checkpoint:
        raise SystemExit("one of --checkpoint / --from_released is required")
    return args.checkpoint
