"""Time every geometry K2b (ops/conv_block.py::in_prelu_bwd) can take at
Model L's K2 sites: each candidate of ops/conv_block.py::
bwd_cluster_candidates (the read-once form: block size x cluster size x
tile width) and
the two-phase form, float32 and bfloat16, at the training batch 128 and
GradCAM's batch 8. The rule in `conv_block.bwd_plan` was chosen from this
table. Not part of the library: run it alone on the card, from the
repository root,

    python3 ctseg_tpu_torch/csrc/tools/sweep_k2b.py [--batches 128 8]
        [--json PATH]

It prints the card's name and power limit, then one line per (batch, site,
type): the bytes' bound (g and xhat read once, dy written once, over 3.35
TB/s), the plan's choice and its time through the wrapper, the wrapper's
sum of dalpha's partials beside torch's one reduction of the same strided
plane, the fastest geometry and each geometry's device milliseconds (CUDA
events, mean of 20 launches after a warm-up, the card kept busy while the
host queues them), each geometry also held to the plain version
(chip_smoke.py's BWD_TOL and DALPHA_RTOL); with --json, the same table as
one JSON file.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from ctseg_tpu_torch.ops import _build  # noqa: E402
from ctseg_tpu_torch.ops import conv_block as k2  # noqa: E402
from ctseg_tpu_torch.ops import instance_norm as k1  # noqa: E402

# (H, W, C) of Model L's K2 sites at a 256x256 input, then two ragged shapes
# that are no sites.
SITES = [(128, 128, 64), (64, 64, 128), (32, 32, 256), (16, 16, 512),
         (16, 16, 1024), (20, 12, 40), (7, 9, 136)]
PEAK_BYTES = 3.35e12


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def name(plan):
    if plan["form"] == "two-phase":
        return f"two-phase, {plan['chunks']} chunks"
    tile = 2 * plan["rows_per_cta"] * plan["wcc"] * 16
    return (f"clusters of {plan['size']} x {plan['threads']} threads, "
            f"{plan['wcc']} vectors ({tile // 1024} KB a block)")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[128, 8])
    parser.add_argument("--json", type=Path, help="write the table here")
    args = parser.parse_args()
    lib = _build.library()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    alpha = torch.full((1,), 0.25, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    table = []
    for n in args.batches:
        for h, w, c in SITES:
            g32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
            xh32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
            rsinv = torch.rand((n, c), generator=gen, device="cuda") + 0.5
            for dtype in (torch.float32, torch.bfloat16):
                g, xhat = g32.to(dtype), xh32.to(dtype)
                dy = torch.empty_like(g)
                s, code = h * w, k2._DTYPE_CODES[dtype]
                plans = k2.bwd_cluster_candidates(n, s, c, g.element_size())
                plans.append({"form": "two-phase",
                              **k1.bwd_plan(n, s, c, g.element_size())})
                means = torch.empty((n, 2, c), device="cuda")
                pdy, pda = k2.in_prelu_bwd_plain(g, xhat, rsinv, alpha)
                terms = (g.float() * torch.clamp_max(xhat.float(), 0.0)
                         ).abs().sum()
                rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                times = []
                for plan in plans:
                    parts = torch.empty(plan["workspace"], device="cuda")
                    if plan["form"] == "cluster":
                        def run(plan=plan, parts=parts):
                            lib.check(lib.ctseg_in_prelu_bwd_saved_cluster(
                                g.data_ptr(), xhat.data_ptr(),
                                rsinv.data_ptr(), alpha.data_ptr(),
                                dy.data_ptr(), parts.data_ptr(), n, s, c,
                                plan["wcc"], plan["size"], plan["threads"],
                                code, 0, stream),
                                "K2b read-once")
                    else:
                        def run(plan=plan, parts=parts):
                            lib.check(lib.ctseg_in_prelu_bwd_saved(
                                g.data_ptr(), xhat.data_ptr(),
                                rsinv.data_ptr(), alpha.data_ptr(),
                                dy.data_ptr(), parts.data_ptr(),
                                means.data_ptr(), n, s, c, plan["vec"],
                                plan["chunks"], plan["rows_per_chunk"], code,
                                0, stream), "K2b two-phase")
                    times.append((name(plan), time_ms(run)))
                    # each geometry is held to the plain version as well
                    dalpha = parts[:, :, 2].sum()
                    if not (torch.allclose(dy.float(), pdy.float(), atol=1e-5,
                                           rtol=rtol)
                            and abs(float(dalpha) - float(pda)) <= 1e-5
                            + 1e-5 * float(terms)):
                        raise AssertionError(f"{name(plan)} at {(n, h, w, c)}"
                                             f" {dtype} disagrees")
                chosen = k2.bwd_plan(n, s, c, g.element_size())
                chosen_ms = time_ms(lambda: k2.in_prelu_bwd(g, xhat, rsinv,
                                                             alpha))
                # dalpha from the chosen workspace's plane 2: one reduction
                # of the strided plane, or by rows first (the wrapper's)
                parts = torch.randn(chosen["workspace"], device="cuda")
                sums = {
                    "one sum": time_ms(lambda: parts[:, :, 2].sum()),
                    "by rows": time_ms(
                        lambda: parts[:, :, 2].sum(dim=-1).sum())}
                bound = 3 * g.numel() * g.element_size() / PEAK_BYTES * 1e3
                best = min(times, key=lambda t: t[1])
                dname = str(dtype).removeprefix("torch.")
                print(f"({n}, {h}, {w}, {c}) {dname}: bound {bound:.4f} ms; "
                      f"plan {name(chosen)} {chosen_ms:.4f} (dalpha's sum "
                      f"{sums['by rows']:.4f}, as one sum "
                      f"{sums['one sum']:.4f}); fastest "
                      f"{best[0]} {best[1]:.4f}; "
                      + "; ".join(f"{k} {v:.4f}" for k, v in times))
                table.append({"shape": [n, h, w, c], "dtype": dname,
                              "bound_ms": bound, "plan": name(chosen),
                              "plan_ms": chosen_ms, "dalpha_sum_ms": sums,
                              "times": dict(times)})
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(table))


if __name__ == "__main__":
    main()
