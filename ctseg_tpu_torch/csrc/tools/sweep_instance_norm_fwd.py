"""Time every geometry the K1 forward kernels take at Model L's IN+PReLU
sites: each candidate of ops/instance_norm.py::fwd_cluster_candidates (the
read-once form: cluster size x tile width) and the two-phase form, float32
and bfloat16, at the serving batch 32 and the training batch 128. The rule in
`fwd_cluster_plan` (the first candidate) was chosen from this table. Not part
of the library: run it alone on the card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/sweep_instance_norm_fwd.py

It prints the card's name and power limit, then one line per (batch, site,
type): the bytes' bound (x read once, y written once, over 3.35 TB/s) and each
geometry's device milliseconds (CUDA events, mean of 20 launches after a
warm-up, the card kept busy while the host queues them).
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from ctseg_tpu_torch.ops import _build  # noqa: E402
from ctseg_tpu_torch.ops import instance_norm as k1  # noqa: E402

SITES = [(128, 128, 64), (64, 64, 128), (32, 32, 256), (16, 16, 512),
         (256, 256, 10)]
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


def main():
    lib = _build.library()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    alpha = torch.full((1,), 0.25, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n in (32, 128):
        for h, w, c in SITES:
            x32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                y = torch.empty_like(x)
                s, code = h * w, k1._DTYPE_CODES[dtype]
                times = []
                for plan in k1.fwd_cluster_candidates(n, s, c, x.element_size()):
                    def cluster(plan=plan):
                        lib.check(lib.ctseg_in_prelu_fwd_cluster(
                            x.data_ptr(), y.data_ptr(), alpha.data_ptr(), None,
                            None, n, s, c, plan["wcc"], plan["size"], code, 0,
                            stream), "read-once forward")
                    times.append((
                        f"clusters of {plan['size']}, {plan['wcc']} vectors "
                        f"({plan['tile_bytes'] // 1024} KB a block)",
                        time_ms(cluster)))
                plan = k1.fwd_plan(n, s, c, x.element_size())
                parts = torch.empty(plan["workspace"], device="cuda")
                mean = torch.empty((n, c), device="cuda")
                var = torch.empty((n, c), device="cuda")

                def two_phase():
                    lib.check(lib.ctseg_in_prelu_fwd(
                        x.data_ptr(), y.data_ptr(), alpha.data_ptr(),
                        parts.data_ptr(), mean.data_ptr(), var.data_ptr(), n,
                        s, c, plan["vec"], plan["chunks"],
                        plan["rows_per_chunk"], code, 0, stream),
                        "two-phase forward")
                times.append((f"two-phase, grid {plan['grid']}",
                              time_ms(two_phase)))
                bound = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
                print(f"{(n, h, w, c)} {str(dtype).split('.')[-1]}, bound "
                      f"{bound:.4f} ms: "
                      + "; ".join(f"{k} {t:.4f}" for k, t in times), flush=True)


if __name__ == "__main__":
    main()
